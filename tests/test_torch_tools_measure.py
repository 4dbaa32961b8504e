"""The port's measuring tools (``odometry_torch/tools/{microbench,roofline,
verify_mm,trace_step,preflight}.py``, the timers of ``utils/profiling.py``)
on the CPU.

The bodies they time are held against the reference's functions on the same
numpy inputs; the work counts against hand counts; the trace parser, the
preflight runner and the timers' refusal without a card on their own. The
times themselves come only from the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 16).
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.geometry import se3_exp as j_se3_exp
from odometry_tpu.image import pyramid as jpyr
from odometry_tpu.image.sampling import sample_bilinear as j_bilinear
from odometry_tpu.image.sampling import sample_channels_mm as j_mm
from odometry_tpu.kernels import points as jp
from odometry_tpu.solvers.linear6 import solve_spd6 as j_solve
from odometry_tpu.solvers.robust import robust_weights as j_weights
from odometry_torch.config import at_size, fast_config
from odometry_torch.image.pyramid import pyr_down
from odometry_torch.tools import microbench, preflight, roofline, trace_step, verify_mm
from odometry_torch.utils import profiling
from tests.torch_tools_reference import one_torch_thread  # noqa: F401 (autouse)

# The lm body's delta: the port's "mm" and "bilinear" residuals equal the
# op-by-op reference's bit for bit (ROADMAP C1); the 6x6 sums J^T W J and
# J^T W r may run in another order (a matmul against the reference's
# einsum), a float32 rounding per term over 512 lanes (~3e-5 relative), and
# the solve amplifies it by the system's condition. Held relative to the
# largest entry of delta (equal bit for bit with this CPU's BLAS).
LM_N = 512
LM_RTOL = 1e-4


def _reference_delta(inputs, interp):
    """The reference's LM body (tools/microbench.py:120-132), op by op."""
    N = len(inputs["xs"])
    with jax.disable_jit():
        img = jnp.asarray(inputs["img"])
        pts = jp.PointSet(xs=jnp.asarray(inputs["xs"]), ys=jnp.asarray(inputs["ys"]),
                          inv_depth=jnp.full((N,), 0.1, jnp.float32),
                          valid=jnp.ones((N,), bool), num=jnp.asarray(N, jnp.int32))
        T = j_se3_exp(jnp.zeros((6,), jnp.float32))
        sys_ = jp.residual_jacobian_points(pts, img, JPinhole.create(*inputs["cam"]), T,
                                           kf_intensity=jnp.asarray(inputs["kf"]),
                                           interp=interp, grads=jpyr.central_gradients(img))
        w = j_weights("huber", sys_.r, sys_.valid, huber_delta=28.0, tdist_dof=200.0,
                      tdist_sigma_init=5.0)
        eqs = jp.normal_equations_points(sys_, w)
        A = eqs.JtWJ + 0.01 * jnp.diag(jnp.diag(eqs.JtWJ)) + 1e-12 * jnp.eye(6)
        return np.asarray(j_solve(A, -eqs.JtWr))


@pytest.mark.parametrize("interp", microbench.INTERPS)
def test_lm_body_delta_matches_the_reference(interp):
    inputs = microbench.lm_inputs(LM_N, 96, 320, seed=3)
    got = microbench.lm_body(inputs, interp, "cpu")().numpy()
    want = _reference_delta(inputs, interp)
    assert np.all(np.isfinite(want)) and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=LM_RTOL * np.abs(want).max())


@pytest.mark.parametrize("n_in,n_out", [(376, 188), (1241, 620), (47, 23)])
def test_pyrdown_matrix_is_the_reference_copy(n_in, n_out):
    np.testing.assert_array_equal(microbench._pyrdown_matrix(n_in, n_out),
                                  jpyr._pyrdown_matrix(n_in, n_out))


def test_matmul_pyr_down_matches_the_ports():
    img = torch.as_tensor(np.random.default_rng(0).uniform(0, 255, (48, 96)), dtype=torch.float32)
    got = microbench.pyr_down_mm(img, *microbench.pyrdown_matrices(48, 96, "cpu"))
    # Float32 sums of five taps in another order: within a few ulps of 255.
    np.testing.assert_allclose(got.numpy(), pyr_down(img).numpy(), rtol=0, atol=1e-3)


def test_suites_declare_their_captures_and_run_on_the_cpu():
    small = at_size(fast_config(), 96, 320)
    for name in ("gather", "sample", "lm", "pyramid"):
        kw = {"sizes": (128,)} if name != "pyramid" else {}
        rows = microbench.SUITES[name]("cpu", **kw)
        assert rows and all(r.captures and r.blocks is None for r in rows), name
    depth = microbench.suite_depth("cpu", small)
    assert [r.captures for r in depth] == [True, True, True, False, False]
    assert all(r.blocks == microbench.REFINE_BLOCKS for r in depth[3:])
    for r in depth:
        r.fn()
    assert profiling.count_ops(depth[0].fn) > 0


def test_search_work_matches_a_hand_count():
    # H=2, W=8, boundary 1, band [1, 3]: per row x = 2..7 give 1, 2, 3, 3, 3, 3
    # candidates (boundary <= xr <= x - 1, x - xr <= 3): 15 pairs, 30 in all.
    assert roofline.search_pairs(2, 8, 1, 1, 3) == 30
    pairs = sum(1 for _ in range(2) for x in range(8) for xr in range(8)
                if xr >= 1 and 1 <= x - xr <= 3)
    assert pairs == 30
    # Two images in, best, match and rmatch out: 5 float32 maps.
    assert roofline.search_work(2, 8, 1, 1, 3, True) == (24 * 30, 4 * 2 * 8 * 5)
    assert roofline.search_work(2, 8, 1, 1, 3, False) == (24 * 30, 4 * 2 * 8 * 4)


def test_row_one_at_kitti_size_is_phase_fours_bound():
    ms, by = roofline.search_bound(376, 1241, 4, 12, 192, True)
    assert by == "operations" and round(ms, 4) == 0.0277
    # The same, from the definition: 24 operations per pair at 67 TFLOP/s.
    assert ms == 1e3 * (24 * roofline.search_pairs(376, 1241, 4, 12, 192) / 67e12)
    c = fast_config()
    from odometry_torch.depth.estimator import search_band
    assert search_band(c.camera, c.depth) == (12, 192)


def test_sample_work_matches_a_hand_count():
    # 4x5 image, C = 2: the points' taps touch {0, 1, 5, 6}, {10, 11, 15, 16}
    # and, clamped at the far corner, {19}: 9 pixels.
    u = torch.tensor([0.5, 0.5, 4.0])
    v = torch.tensor([0.5, 2.5, 3.0])
    assert roofline.sample_work(2, 4, 5, u, v) == (3 * (4 + 18), 4 * (2 * 9 + 2 * 3 + 2 * 3))


def test_pyramid_and_pattern_work_match_hand_counts():
    # 8x12, 3 levels: the blur 10 * 96; pyr_down 8x12 -> 4x6: 9 * 8 * 6 +
    # 9 * 4 * 6; 4x6 -> 2x3: 9 * 4 * 3 + 9 * 2 * 3. Bytes: the input and the
    # three levels (96 + 24 + 6 pixels), float32.
    assert roofline.pyramid_work(8, 12, 3) == (960 + 648 + 162, 4 * (96 + 96 + 24 + 6))
    assert roofline.pattern_work(3, 4) == (15 * 12, 4 * 12 * 10)


def test_bound_names_the_larger_side():
    assert roofline.bound(67e9, 0) == (1.0, "operations")
    assert roofline.bound(0, 3.35e9) == (1.0, "bytes")


def test_verify_mm_sampler_invariant_against_the_reference():
    img = np.random.default_rng(0).uniform(0.0, 255.0, (64, 200)).astype(np.float32)
    u = jnp.asarray(verify_mm.PROBE_U, jnp.float32)
    v = jnp.asarray(verify_mm.PROBE_V, jnp.float32)
    a = np.asarray(j_bilinear(jnp.asarray(img), u, v))
    b = np.asarray(j_mm(jnp.asarray(img)[None], u, v, dtype=jnp.float32))[0]
    want = float(np.max(np.abs(a - b)))
    got = verify_mm.sampler_error(device="cpu")
    assert got < verify_mm.SAMPLER_GATE and want < verify_mm.SAMPLER_GATE
    assert abs(got - want) <= 1e-4


def test_verify_mm_pyramid_invariant_against_the_reference():
    H, W = 48, 96
    errs = verify_mm.pyramid_errors(H, W, device="cpu")
    big = np.random.default_rng(1).uniform(0.0, 255.0, (H, W)).astype(np.float32)
    golden = np.asarray(jpyr._sep_conv(jnp.asarray(big), jpyr.GAUSS5))[0:H:2, 0:W:2]
    t = torch.as_tensor(big)
    np.testing.assert_allclose(pyr_down(t).numpy(), golden, rtol=0, atol=1e-3)
    assert errs["conv"] < verify_mm.PYRAMID_GATE and errs["matmul"] < 1e-3
    verify_mm.check_invariants(0.0, errs)
    with pytest.raises(RuntimeError):
        verify_mm.check_invariants(1.0, errs)


def test_verify_mm_gates_raise():
    ok = dict(failed_at=None, mte=0.05, keyframes=2)
    verify_mm.check_fast(ok)
    for bad in (dict(ok, failed_at=3), dict(ok, mte=0.10), dict(ok, keyframes=1)):
        with pytest.raises(RuntimeError):
            verify_mm.check_fast(bad)
    verify_mm.check_kitti(dict(mte=0.149))
    with pytest.raises(RuntimeError):
        verify_mm.check_kitti(dict(mte=0.15))


def _event(name, dur, cat="kernel", ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 0, "dur": dur}


def test_parse_reads_a_hand_written_chrome_trace(tmp_path):
    events = [
        _event("void band_kernel<true>(float const*, float const*)", 100.0),
        _event("void band_kernel<true>(float const*, float const*)", 60.0),
        *[_event("void at::native::vectorized_elementwise_kernel<4, at::native::"
                 "CUDAFunctor_add<float>>", 5.0) for _ in range(3)],
        _event("void at::native::index_elementwise_kernel<128, 4>", 7.0),
        _event("void at::native::reduce_kernel<512, 1>", 4.0),
        _event("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8", 10.0),
        _event("Memcpy HtoD (Pageable -> Device)", 2.0, cat="gpu_memcpy"),
        _event("void mystery_kernel()", 1.0),
        _event("aten::add", 50.0, cat="cpu_op"),  # host: not counted
        _event("band_kernel", 0.0, ph="i"),  # an instant: not counted
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    lines = []
    out = trace_step.parse(str(path), top=3, log=lines.append)
    assert out["total_ms"] == pytest.approx(0.199)
    assert dict(out["by_category"]) == pytest.approx({
        "ssd": 0.160, "elementwise": 0.015, "gemm": 0.010, "index/scatter": 0.007,
        "reduction": 0.004, "copy": 0.002, "other": 0.001})
    assert [c for c, _ in out["by_category"]][:2] == ["ssd", "elementwise"]
    top = out["rows"][0]
    assert top["count"] == 2 and top["self_ms"] == pytest.approx(0.160)
    assert out["rows"][1]["count"] == 3 and out["rows"][1]["category"] == "elementwise"
    assert lines[0] == "total device self time: 0.199 ms"
    assert len([ln for ln in lines if "BY-CAT" in ln]) == 7
    assert len(lines) == 1 + 7 + 1 + 3


@pytest.mark.parametrize("code,timeout,green,says", [
    ("print('fine')", 30, True, "fine"),
    ("import sys; print('broke'); sys.exit(1)", 30, False, "broke"),
    ("import time; time.sleep(30)", 1, False, "timeout after 1s"),
])
def test_preflight_run_says_green_or_red(code, timeout, green, says):
    lines = []
    ok = preflight.run("step", [sys.executable, "-c", code], timeout, log=lines.append)
    assert ok is green and len(lines) == 1
    assert lines[0].startswith(f"[preflight] step: {'GREEN' if green else 'RED'} (")
    assert lines[0].endswith(says)


def test_preflight_steps():
    assert [s[0] for s in preflight.steps(quick=True)] == ["bench"]
    names = [s[0] for s in preflight.steps(sweep=True)]
    assert names == ["bench", "pytest-torch_cuda", "kernel-parity", "accuracy-sweep"]
    pytest_step = preflight.steps()[1]
    assert "-m" in pytest_step[1] and "cuda" in pytest_step[1] and pytest_step[3] == (0, 5)


def test_count_ops_counts_dispatched_operators():
    x = torch.ones(3)
    assert profiling.count_ops(lambda: (x + 1) * 2) == 2


@pytest.mark.parametrize("timer", ["device_ms", "graph_ms", "busy_ms", "wall_ms", "capture"])
def test_timers_raise_without_a_card(timer, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        getattr(profiling, timer)(lambda: torch.ones(1), 2)


@pytest.mark.parametrize("tool", [microbench, roofline, verify_mm, trace_step, preflight])
def test_tools_default_to_the_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])
