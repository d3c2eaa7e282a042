"""The spans and counter of the unfused LM iteration and of the Gaussian
map's insert (``utils/profiling.py``), on the CPU: a VGICP align records
``lm.search``, ``lm.factors`` and ``lm.pack`` inside ``lm.linearize`` and
counts every iteration in ``lm_unfused_iterations``; a Gaussian insert
records the incremental insert's four steps and ``insert.sums``; a fused
GICP align records none of them and keeps its counters."""

import numpy as np
import pytest
import torch

from small_gicp_tpu_torch.models.helper import preprocess_points
from small_gicp_tpu_torch.models.registration import align_impl
from small_gicp_tpu_torch.models.voxelmap import GaussianVoxelMap
from small_gicp_tpu_torch.utils import profiling, synthetic

UNFUSED_SPANS = {"lm.search", "lm.factors", "lm.pack"}
INSERT_SPANS = {"insert.sort", "insert.sums", "insert.lookup", "insert.evict",
                "insert.scatter"}


@pytest.fixture(autouse=True)
def clean_record():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    scans, poses = synthetic.generate_sequence(n_frames=2, rings=8, azimuth_steps=128)
    clouds = [preprocess_points(s.astype(np.float32), 0.25, 10, device="cpu") for s in scans]
    T0 = torch.as_tensor(np.linalg.inv(poses[0]) @ poses[1], dtype=torch.float32)
    return clouds, T0


def test_vgicp_align_records_the_unfused_spans(pair):
    (target, _), (source, _) = pair[0]
    vm = GaussianVoxelMap.build(target, 1.0, num_offsets=7)
    with profiling.tracing():
        r = align_impl(vm, source, None, pair[1])
    rec = profiling.collected()
    spans, counters = rec["spans"], rec["counters"]
    n = counters["lm_iterations"]
    assert n == int(r.iterations) + 1
    assert counters["lm_unfused_iterations"] == n
    for name in UNFUSED_SPANS | {"lm.linearize"}:
        assert spans[name]["count"] == n, name
    inside = sum(spans[k]["total_s"] for k in UNFUSED_SPANS)
    assert inside <= spans["lm.linearize"]["total_s"]
    by_id = {x["id"]: x for x in rec["records"]}
    for x in rec["records"]:
        if x["name"] in UNFUSED_SPANS:
            assert by_id[x["parent"]]["name"] == "lm.linearize"


def test_gaussian_insert_records_its_five_steps(pair):
    (target, _), _ = pair[0]
    vm = GaussianVoxelMap.empty(1.0, capacity=4096, device="cpu")
    with profiling.tracing():
        vm = vm.insert(target)
        vm = vm.insert(target, torch.eye(4))
    spans = profiling.collected()["spans"]
    assert INSERT_SPANS <= set(spans)
    assert all(spans[k]["count"] == 2 for k in INSERT_SPANS)
    assert int(vm.num_voxels) > 0


def test_fused_gicp_align_records_none_of_them(pair):
    (target, tree), (source, _) = pair[0]
    with profiling.tracing():
        r = align_impl(target, source, tree, pair[1])
    rec = profiling.collected()
    assert not (UNFUSED_SPANS | INSERT_SPANS) & set(rec["spans"])
    n = int(r.iterations) + 1
    assert rec["counters"] == {"registrations": 1, "lm_iterations": n, "host_reads": n}
