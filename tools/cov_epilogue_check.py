#!/usr/bin/env python3
"""K3's epilogue on the card: how torch rounds the epilogue's ops, and what
the fused epilogue saves.

    python3 tools/cov_epilogue_check.py [--semantics-only]

1. Semantics. K3's epilogue (``csrc/cov_fused.cu`` ``cov_epilogue``)
   repeats the float32 ops of the torch epilogue (``ops/normals.py``
   ``_torch_epilogue``, ``ops/eigh3.py`` ``smallest_eigvec3x3``) bit for
   bit. For each op whose rounding IEEE alone does not fix, torch's result
   over two million random operands is held against candidate forms, each
   built from ops that round once apiece (a fused multiply-add from
   float64, where a product of two float32 is exact); the number of
   elements on which each candidate differs from torch is printed, and the
   right form differs on none.
2. Cost, on frames of the synthetic HDL-64 world downsampled at 0.25 m, at
   k = 10 and 20 with the tree's kept sort: K3 alone (profiler device time
   over 20 calls) in its moment mode and in its epilogue mode; the
   covariance stage with the torch epilogue over K3's rows against K3 with
   its epilogue — CUDA runtime calls (launches, copies, memsets) a call by
   the profiler, and host time a call (median of 50, each ended by a
   synchronize) — and whether the two agree bit for bit.

One JSON line a part goes to standard output and to
``chiprun_out/cov_epilogue_check.jsonl``.
"""

import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _emit(record: dict) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "cov_epilogue_check.jsonl", "a") as f:
        f.write(line + "\n")


def _differs(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def _fma(a, b, c):
    """fmaf(a, b, c) in float32: the product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _reduce_forms(e: torch.Tensor):
    """(name, sum over the columns of ``e``) in the orders of torch's reduce
    kernel for a contiguous reduced dimension: ``width`` lanes take every
    width-th element into ``vt`` accumulators each (``thread_reduce_impl``:
    full rounds of vt, then a tail, the accumulators combined in order),
    then the lanes combine by shuffles at offsets 1, 2, 4, … ("up") or
    width/2, …, 1 ("down")."""
    m = e.shape[1]
    for width in (1, 2, 4, 8, 16):
        for vt in (1, 2, 4, 8):
            lanes = []
            for t in range(width):
                acc = [None] * vt
                idx = t
                while idx + (vt - 1) * width < m:
                    for i in range(vt):
                        x = e[:, idx + i * width]
                        acc[i] = x if acc[i] is None else acc[i] + x
                    idx += width * vt
                for i in range(vt):
                    if idx >= m:
                        break
                    acc[i] = e[:, idx] if acc[i] is None else acc[i] + e[:, idx]
                    idx += width
                got = [a for a in acc if a is not None]
                v = got[0] if got else None
                for a in got[1:]:
                    v = v + a
                lanes.append(v)
            for order, offsets in (("up", [1 << j for j in range(width.bit_length() - 1)]),
                                   ("down", [width >> j for j in range(1, width.bit_length())])):
                val = list(lanes)
                for off in offsets:
                    val = [(a if b is None else (b if a is None else a + b))
                           if t + off < width else a
                           for t, (a, b) in enumerate(zip(val, val[off:] + [None] * off))]
                yield f"w{width} vt{vt} {order}", val[0]


def semantics(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(3)
    n = 1 << 21

    def rnd(*shape):
        # Mixed magnitudes, so that the candidates' roundings part.
        x = torch.randn(*shape, device=dev, generator=g)
        return x * torch.exp2(torch.randint(-6, 7, shape, device=dev, generator=g).float())

    out = {"part": "semantics", "torch": torch.__version__, "cuda": torch.version.cuda}
    x = rnd(n)
    for d in (3.0, 6.0):
        inv = (torch.tensor(1.0) / torch.tensor(d)).item()  # float32 reciprocal
        out[f"x/{d:g}"] = {"x*f32(1/d)": _differs(x / d, x * inv),
                           "true division": _differs(x / d, x / torch.full_like(x, d))}
    p = x.abs() + 0.5
    out["p**3"] = {"(p*p)*p": _differs(p ** 3, (p * p) * p)}
    c = 2.0 * math.pi / 3.0
    out["x+2pi/3"] = {"x+f32(c)": _differs(x + c, x + torch.tensor(c).float().item())}

    a = rnd(n, 3)
    sq = a * a
    forms3 = {"(0+1)+2": (sq[:, 0] + sq[:, 1]) + sq[:, 2],
              "(0+2)+1": (sq[:, 0] + sq[:, 2]) + sq[:, 1]}
    out["sum3"] = {k: _differs(torch.sum(a * a, dim=-1), v) for k, v in forms3.items()}
    out["sum3 keepdim"] = {k: _differs(torch.sum(a * a, dim=-1, keepdim=True)[:, 0], v)
                           for k, v in forms3.items()}
    pts = rnd(n, 4)
    xv = pts[:, :3] * a
    out["sum3 of a strided view"] = {
        "(0+2)+1": _differs(torch.sum(pts[:, :3] * a, dim=-1),
                            (xv[:, 0] + xv[:, 2]) + xv[:, 1])}

    B = rnd(n, 3, 3)
    B = B + B.transpose(-1, -2)
    e = (B * B).reshape(n, 9)
    seq = e[:, 0]
    for j in range(1, 9):
        seq = seq + e[:, j]
    s9 = torch.sum(B * B, dim=(-1, -2))
    out["sum9"] = {"in order": _differs(s9, seq)}
    out["sum9"].update({name: _differs(s9, form) for name, form in _reduce_forms(e)})

    u, v = rnd(n, 3), rnd(n, 3)
    cr = torch.linalg.cross(u, v)

    def comp(i, j):  # u_i·v_j − u_j·v_i in each candidate form
        a_, b_, c_, d_ = u[:, i], v[:, j], u[:, j], v[:, i]
        return {"no fma": a_ * b_ - c_ * d_,
                "fma(a,b,-cd)": _fma(a_, b_, -(c_ * d_)),
                "fma(-c,d,ab)": _fma(-c_, d_, a_ * b_)}

    forms = [comp(1, 2), comp(2, 0), comp(0, 1)]
    out["cross"] = {name: sum(_differs(cr[:, k], forms[k][name]) for k in range(3))
                    for name in forms[0]}
    return out


def _device_ms(fn, pattern: str, reps: int = 20) -> float:
    """Device time a call of the kernels whose name holds ``pattern``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if pattern in e.key:
            total += getattr(e, "device_time_total", 0.0) or e.cuda_time_total
    return total / 1e3 / reps


def _runtime_calls(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()}
    return {"launches": sum(v for k, v in calls.items() if "LaunchKernel" in k),
            "copies": sum(v for k, v in calls.items() if k.startswith("cudaMemcpy")),
            "memsets": sum(v for k, v in calls.items() if k.startswith("cudaMemset"))}


def _host_ms(fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def cost(dev) -> list:
    from small_gicp_tpu_torch.models.helper import preprocess_points
    from small_gicp_tpu_torch.ops.cov_fused_cuda import (
        knn_moments,
        knn_moments_rows,
        knn_normals_covs,
    )
    from small_gicp_tpu_torch.ops.normals import _torch_epilogue
    from small_gicp_tpu_torch.point_cloud import PointCloud
    from small_gicp_tpu_torch.utils.synthetic import generate_sequence_device

    frames, counts, _ = generate_sequence_device(n_frames=2, rings=64, azimuth_steps=1800,
                                                 device=dev)
    rows = []
    for f in range(frames.shape[0]):
        cloud, tree = preprocess_points(
            PointCloud(points=frames[f].contiguous(), num_points=counts[f]), 0.25)
        pts, num, target = cloud.points, cloud.num_points, tree.pruned_target()
        for k in (10, 20):
            def torch_stage(need_normals=True):
                return _torch_epilogue(pts, num, *knn_moments(pts, num, k, target=target),
                                       need_normals, True)

            def fused_stage(need_normals=True):
                return knn_normals_covs(pts, num, k, need_normals, True, target=target)

            same = all((a is None and b is None) or torch.equal(a, b)
                       for need in (True, False)
                       for a, b in zip(torch_stage(need), fused_stage(need)))
            rows.append({
                "part": "cost", "frame": f, "rows": int(num), "k": k, "equal": same,
                "k3_moments_alone_ms": _device_ms(
                    lambda: knn_moments_rows(pts, num, k, target=target),
                    "knn_moments_kernel"),
                "k3_epilogue_alone_ms": _device_ms(fused_stage, "knn_moments_kernel"),
                "k3_covs_only_alone_ms": _device_ms(lambda: fused_stage(False),
                                                    "knn_moments_kernel"),
                "torch_stage_calls": _runtime_calls(torch_stage),
                "fused_stage_calls": _runtime_calls(fused_stage),
                "torch_stage_host_ms": _host_ms(torch_stage),
                "fused_stage_host_ms": _host_ms(fused_stage),
                "torch_stage_covs_only_host_ms": _host_ms(lambda: torch_stage(False)),
                "fused_stage_covs_only_host_ms": _host_ms(lambda: fused_stage(False))})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    _emit(dict(semantics(dev), device=torch.cuda.get_device_name(0)))
    if "--semantics-only" not in sys.argv:
        for row in cost(dev):
            _emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
