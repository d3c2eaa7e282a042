"""Port parity: Lie maps, 3x3/6x6 algebra, voxel keys, the synthetic
generator, and the guards that keep the port free of JAX.

Inputs are made with numpy and fed to both packages; tolerances are float64
round-off unless stated. Each file of the port's tests stays at ten test
items or fewer, so that pytest-xdist's largest-file-first queue hands out
the JAX package's test files in the same order as without them.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops import eigh3 as jeig
from small_gicp_tpu.ops import voxel_keys as jvk
from small_gicp_tpu.utils import lie as jlie
from small_gicp_tpu.utils import synthetic as jsyn
from small_gicp_tpu_torch.ops import eigh3 as teig
from small_gicp_tpu_torch.ops import voxel_keys as tvk
from small_gicp_tpu_torch.utils import lie as tlie
from small_gicp_tpu_torch.utils import synthetic as tsyn

REPO = Path(__file__).resolve().parents[1]


def _j(x):
    return np.array(x)  # a writable copy, so torch can wrap it


def _t(x):
    return x.detach().cpu().numpy()


def test_lie_exp_matches_jax():
    # θ spans the exact branch, the (θ−sinθ)/θ³ Taylor branch (< 1e-2),
    # the full small-angle branch (< 1e-5) and zero.
    for theta in [0.0, 3e-7, 4e-6, 2e-3, 0.3, 2.5]:
        rng = np.random.default_rng(int(theta * 1e7) % 1000)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        tw = np.r_[axis * theta, rng.normal(size=3)]
        msg = f"theta={theta}"
        np.testing.assert_allclose(_t(tlie.se3_exp(torch.as_tensor(tw))),
                                   _j(jlie.se3_exp(jnp.asarray(tw))), atol=1e-14,
                                   err_msg=msg)
        np.testing.assert_allclose(_t(tlie.so3_exp(torch.as_tensor(tw[:3]))),
                                   _j(jlie.so3_exp(jnp.asarray(tw[:3]))),
                                   atol=1e-14, err_msg=msg)
        np.testing.assert_array_equal(_t(tlie.skew(torch.as_tensor(tw[:3]))),
                                      _j(jlie.skew(jnp.asarray(tw[:3]))),
                                      err_msg=msg)
    T = _j(jlie.se3_exp(jnp.asarray([0.1, -0.2, 0.3, 1.0, 2.0, -3.0])))
    np.testing.assert_allclose(_t(tlie.rigid_inverse(torch.as_tensor(T))),
                               _j(jlie.rigid_inverse(jnp.asarray(T))), atol=1e-15)


def test_so3_log_matches_jax():
    axis = np.array([0.3, -0.5, 0.81])
    axis /= np.linalg.norm(axis)
    R2 = _j(jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.4])))
    for theta in [0.0, 4e-6, 0.7, np.pi - 1e-3, np.pi - 1e-6]:
        R = _j(jlie.so3_exp(jnp.asarray(axis * theta)))
        got = _t(tlie.so3_log(torch.as_tensor(R)))
        # Near π both recover θ from atan2 and share the sinθ division, so
        # they agree to the round-off of that division (~1e-16/sinθ).
        np.testing.assert_allclose(got, _j(jlie.so3_log(jnp.asarray(R))),
                                   atol=1e-9, err_msg=f"theta={theta}")
        np.testing.assert_allclose(
            float(tlie.rotation_error_deg(torch.as_tensor(R), torch.as_tensor(R2))),
            float(jlie.rotation_error_deg(jnp.asarray(R), jnp.asarray(R2))),
            atol=1e-9, err_msg=f"theta={theta}")


def _spd(rng, n):
    a = rng.normal(size=(n, 3, 3))
    return np.einsum("nij,nkj->nik", a, a) + 1e-2 * np.eye(3)


def test_inv3x3_matches_jax_with_det_guard():
    rng = np.random.default_rng(1)
    A = _spd(rng, 64)
    A[0] = 0.0  # det 0 → guarded to the zero matrix
    A[1] = np.diag([1e-11, 1e-11, 1e-11])  # det 1e-33 < 1e-30 → zero too
    got = _t(teig.inv3x3(torch.as_tensor(A)))
    np.testing.assert_allclose(got, _j(jeig.inv3x3(jnp.asarray(A))),
                               rtol=1e-12, atol=1e-12)
    assert np.all(got[:2] == 0.0)


def test_smallest_eigvec_matches_jax():
    rng = np.random.default_rng(2)
    A = _spd(rng, 64)
    A[0] = 3.0 * np.eye(3)  # isotropic: e0 by convention
    A[1] = np.diag([1.0, 1.0, 0.0])  # planar: the normal is ±z
    A[2] = np.diag([1.0, 0.0, 0.0])  # linear: degenerate smallest pair
    got = _t(teig.smallest_eigvec3x3(torch.as_tensor(A)))
    want = _j(jeig.smallest_eigvec3x3(jnp.asarray(A)))
    keep = np.arange(len(A)) != 2
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-12)
    np.testing.assert_array_equal(got[0], [1.0, 0.0, 0.0])
    np.testing.assert_allclose(np.abs(got[1]), [0.0, 0.0, 1.0], atol=1e-12)
    # Linear case: any unit vector of the degenerate y-z plane is right, and
    # the pivot between the tied cross products follows last-bit rounding
    # of arccos, so only the plane is pinned.
    np.testing.assert_allclose(np.linalg.norm(got[2]), 1.0, atol=1e-12)
    assert abs(got[2][0]) < 1e-12


def test_solve6x6_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(6, 6))
    H = a @ a.T + 1e-3 * np.eye(6)
    b = rng.normal(size=6)
    lams = np.array([1e-6, 1e-3, 1.0, 1e3])
    got = _t(teig.solve6x6(torch.as_tensor(H), torch.as_tensor(b),
                           torch.as_tensor(lams)))
    for k, lam in enumerate(lams):
        want = _j(jeig.solve6x6(jnp.asarray(H), jnp.asarray(b), jnp.asarray(lam)))
        np.testing.assert_allclose(got[k], want, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose((H + lam * np.eye(6)) @ got[k], b, atol=1e-8)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_voxel_keys_bit_equal(dtype):
    for leaf in (0.25, 0.3):
        _check_voxel_keys(dtype, leaf)


def _check_voxel_keys(dtype, leaf):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-60, 60, size=(2000, 3)).astype(dtype)
    # Exact multiples of the leaf sit on voxel boundaries, where
    # p·(1/leaf) and p/leaf round to different sides.
    pts[:200] = (rng.integers(-200, 200, size=(200, 3)) * dtype(leaf)).astype(dtype)
    pts[200] = np.nan
    pts[201] = [np.inf, 0.0, 0.0]
    pts[202:210] = 1e9  # sentinel rows
    pts[210] = [5e5, 0.0, 0.0]  # outside the 21-bit range at both leaves
    got = _t(tvk.voxel_keys(torch.as_tensor(pts), leaf))
    want = _j(jvk.voxel_keys(jnp.asarray(pts), jnp.asarray(leaf, dtype)))
    np.testing.assert_array_equal(got, want)
    assert np.all(got[200:211] == tvk.INVALID_KEY)
    order, keys_s, valid, seg, num = tvk.sort_segments(torch.as_tensor(want))
    jorder, jkeys_s, jvalid, jseg, jnum = jvk.sort_segments(jnp.asarray(want))
    np.testing.assert_array_equal(_t(order), _j(jorder))
    np.testing.assert_array_equal(_t(seg), _j(jseg))
    assert int(num) == int(jnum)


def test_synthetic_copy_bit_equal():
    scans, poses = tsyn.generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    jscans, jposes = jsyn.generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    np.testing.assert_array_equal(poses, jposes)
    assert len(scans) == len(jscans)
    for a, b in zip(scans, jscans):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- guards --

def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "small_gicp_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        bad = {m for m in _imported_roots(f)
               if m in ("jax", "jaxlib", "flax", "small_gicp_tpu")}
        assert not bad, f"{f.relative_to(REPO)} imports {bad}"


def test_port_import_loads_no_jax_module():
    code = (
        "import sys, small_gicp_tpu_torch, small_gicp_tpu_torch.interop, "
        "small_gicp_tpu_torch.utils.synthetic, small_gicp_tpu_torch._build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'small_gicp_tpu')]\n"
        "print(bad)\nsys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

