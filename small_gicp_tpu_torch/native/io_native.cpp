// Native host-side point-cloud IO and a prefetching dataset loader.
//
// KITTI .bin and PLY xyz readers and a loader whose background thread
// parses scans ahead of the consumer into a bounded queue, so that scan
// i+1 is read from disk while scan i registers on the card (reference:
// include/small_gicp/benchmark/read_points.hpp:15-109 readers,
// benchmark/benchmark.hpp:96-144 KittiDataset). A plain C interface, loaded
// with ctypes by small_gicp_tpu_torch/native/__init__.py, which builds it
// with g++ -O3 -shared -fPIC -std=c++17 -pthread at first use.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ----------------------------------------------------------------------
// KITTI .bin: float32 x,y,z,intensity records.
// Returns number of points written (<= max_points), or -1 on error.
int64_t sgt_read_kitti_bin(const char* path, float* out_xyz, int64_t max_points) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  const int64_t n_file = size / (4 * sizeof(float));
  const int64_t n = n_file < max_points ? n_file : max_points;
  std::vector<float> buf(static_cast<size_t>(n) * 4);
  const size_t got = std::fread(buf.data(), 4 * sizeof(float), n, f);
  std::fclose(f);
  for (size_t i = 0; i < got; i++) {
    out_xyz[i * 3 + 0] = buf[i * 4 + 0];
    out_xyz[i * 3 + 1] = buf[i * 4 + 1];
    out_xyz[i * 3 + 2] = buf[i * 4 + 2];
  }
  return static_cast<int64_t>(got);
}

// ----------------------------------------------------------------------
// Minimal PLY reader: binary_little_endian or ascii, float32 x/y/z among
// arbitrary scalar vertex properties (same scope as the reference's
// read_ply, read_points.hpp:52-77, plus property skipping).
static int ply_type_size(const std::string& t) {
  if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
  if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") return 2;
  if (t == "int" || t == "uint" || t == "int32" || t == "uint32" ||
      t == "float" || t == "float32")
    return 4;
  if (t == "double" || t == "float64") return 8;
  return -1;
}

int64_t sgt_read_ply_xyz(const char* path, float* out_xyz, int64_t max_points) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  if (!std::fgets(line, sizeof(line), f) || std::strncmp(line, "ply", 3) != 0) {
    std::fclose(f);
    return -1;
  }
  bool binary = false, ascii = false;
  int64_t n_vertex = 0;
  bool in_vertex = false;
  int stride = 0;
  int off_x = -1, off_y = -1, off_z = -1;
  int sz_x = 4;
  while (std::fgets(line, sizeof(line), f)) {
    std::string s(line);
    if (s.rfind("format binary_little_endian", 0) == 0) binary = true;
    else if (s.rfind("format ascii", 0) == 0) ascii = true;
    else if (s.rfind("element", 0) == 0) {
      char name[128];
      long long cnt = 0;
      std::sscanf(line, "element %127s %lld", name, &cnt);
      in_vertex = std::strcmp(name, "vertex") == 0;
      if (in_vertex) n_vertex = cnt;
    } else if (s.rfind("property", 0) == 0 && in_vertex) {
      char type[64], name[128];
      if (std::sscanf(line, "property %63s %127s", type, name) == 2) {
        const int sz = ply_type_size(type);
        if (sz < 0) { std::fclose(f); return -1; }
        if (std::strcmp(name, "x") == 0) { off_x = stride; sz_x = sz; }
        if (std::strcmp(name, "y") == 0) off_y = stride;
        if (std::strcmp(name, "z") == 0) off_z = stride;
        stride += sz;
      }
    } else if (s.rfind("end_header", 0) == 0) {
      break;
    }
  }
  if ((!binary && !ascii) || off_x < 0 || off_y < 0 || off_z < 0) {
    std::fclose(f);
    return -1;
  }
  const int64_t n = n_vertex < max_points ? n_vertex : max_points;
  if (binary) {
    std::vector<uint8_t> rec(static_cast<size_t>(stride) * n);
    const size_t got = std::fread(rec.data(), stride, n, f);
    std::fclose(f);
    for (size_t i = 0; i < got; i++) {
      const uint8_t* base = rec.data() + i * stride;
      if (sz_x == 4) {
        float v;
        std::memcpy(&v, base + off_x, 4); out_xyz[i * 3 + 0] = v;
        std::memcpy(&v, base + off_y, 4); out_xyz[i * 3 + 1] = v;
        std::memcpy(&v, base + off_z, 4); out_xyz[i * 3 + 2] = v;
      } else {
        double v;
        std::memcpy(&v, base + off_x, 8); out_xyz[i * 3 + 0] = (float)v;
        std::memcpy(&v, base + off_y, 8); out_xyz[i * 3 + 1] = (float)v;
        std::memcpy(&v, base + off_z, 8); out_xyz[i * 3 + 2] = (float)v;
      }
    }
    return static_cast<int64_t>(got);
  }
  // ascii: assume x y z are the first three columns (reference scope).
  for (int64_t i = 0; i < n; i++) {
    float x, y, z;
    if (std::fscanf(f, "%f %f %f%*[^\n]", &x, &y, &z) != 3) {
      std::fclose(f);
      return i;
    }
    out_xyz[i * 3 + 0] = x;
    out_xyz[i * 3 + 1] = y;
    out_xyz[i * 3 + 2] = z;
  }
  std::fclose(f);
  return n;
}

// ----------------------------------------------------------------------
// Prefetching dataset loader: a background thread reads scans ahead of
// the consumer into a bounded queue (the host-side half of the
// reference's flow-graph pipelining, odometry_benchmark_tbb_flow.cpp).

struct Scan {
  std::vector<float> xyz;
  int64_t n = 0;
};

struct Loader {
  std::vector<std::string> paths;
  int64_t max_points;
  bool kitti;
  size_t next_read = 0;
  size_t completed = 0;  // scans pushed to `ready` so far (guarded by mu)
  std::deque<std::unique_ptr<Scan>> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<bool> stop{false};
  size_t prefetch;
  std::thread worker;

  void run() {
    while (!stop.load()) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() || next_read >= paths.size() ||
                 ready.size() < prefetch;
        });
        if (stop.load() || next_read >= paths.size()) return;
        idx = next_read++;
      }
      auto scan = std::unique_ptr<Scan>(new Scan());
      scan->xyz.resize(static_cast<size_t>(max_points) * 3);
      scan->n = kitti
                    ? sgt_read_kitti_bin(paths[idx].c_str(), scan->xyz.data(), max_points)
                    : sgt_read_ply_xyz(paths[idx].c_str(), scan->xyz.data(), max_points);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push_back(std::move(scan));
        completed++;
      }
      cv_ready.notify_one();
    }
  }
};

void* sgt_loader_create(const char** paths, int64_t n_paths, int64_t max_points,
                        int32_t kitti, int64_t prefetch) {
  auto* l = new Loader();
  l->paths.assign(paths, paths + n_paths);
  l->max_points = max_points;
  l->kitti = kitti != 0;
  l->prefetch = static_cast<size_t>(prefetch > 0 ? prefetch : 4);
  l->worker = std::thread([l] { l->run(); });
  return l;
}

// Blocks until the next scan is ready; returns its point count (0 for an
// empty scan), -2 when the dataset is exhausted, -1 on a read error for that
// scan.
int64_t sgt_loader_next(void* handle, float* out_xyz) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_ptr<Scan> scan;
  {
    std::unique_lock<std::mutex> lk(l->mu);
    l->cv_ready.wait(lk, [&] {
      return !l->ready.empty() || l->completed >= l->paths.size();
    });
    if (l->ready.empty()) return -2;  // exhausted
    scan = std::move(l->ready.front());
    l->ready.pop_front();
  }
  l->cv_space.notify_one();
  if (scan->n > 0) {
    std::memcpy(out_xyz, scan->xyz.data(), static_cast<size_t>(scan->n) * 3 * sizeof(float));
  }
  return scan->n;
}

void sgt_loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->cv_space.notify_all();
  l->cv_ready.notify_all();
  if (l->worker.joinable()) l->worker.join();
  delete l;
}

}  // extern "C"
