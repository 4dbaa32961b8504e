"""The port on several cards, checked on the CPU: the default mesh over every
card (ROADMAP C16), B3's launch plan and bound, the split the sweep refuses,
and ``odometry_torch/tools/multichip.py``'s dry run and per-process runner,
each against the reference where it has a counterpart.

No card is needed: a mesh only names devices, so the card tests patch
``torch.cuda.is_available`` and ``device_count``, and the launch plan is a
function of ``torch.device`` objects. The kernels themselves run on the
cards in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from odometry_tpu import config as jc
from odometry_tpu.distributed import mesh as jmesh
from odometry_tpu.distributed import sweep as jsw
from odometry_torch import config as tc
from odometry_torch.distributed import ring_exchange
from odometry_torch.distributed import sweep as tsw
from odometry_torch.distributed.mesh import grid_mesh, sequence_mesh, spread
from odometry_torch.distributed.ring_exchange import launch_plan, ring_gather
from odometry_torch.kernels import _build
from odometry_torch.tools import multichip
from tests.torch_tools_reference import one_torch_thread  # noqa: F401 (autouse)

# tests/test_torch_distributed.py's pose tolerance of two float32 trackers (C1).
POSE_ATOL = 5e-4


def cuda(k):
    return torch.device("cuda", k)


@pytest.fixture
def visible(monkeypatch):
    """visible(c): make c cards visible to sequence_mesh and grid_mesh."""

    def patch(count):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)

    return patch


def test_default_mesh_takes_every_card(visible):
    """C16: sequence_mesh() has one rank per visible card, as the
    reference's takes every device (conftest's 8 CPU devices)."""
    visible(8)
    mesh = sequence_mesh()
    assert list(mesh.devices) == [cuda(k) for k in range(8)]
    ref = jmesh.sequence_mesh()
    assert ref.devices.size == 8 and mesh.shape == dict(ref.shape)


def test_meshes_take_the_first_cards(visible):
    """C16: sequence_mesh(n) and grid_mesh(seq, model) take the first cards,
    row-major, where the reference takes the first devices; an index names
    one card for every rank."""
    visible(8)
    assert list(sequence_mesh(2).devices) == [cuda(0), cuda(1)]
    grid, ref = grid_mesh(2, 4), jmesh.grid_mesh(2, 4)
    assert grid.devices.tolist() == [[cuda(k) for k in range(4)], [cuda(k) for k in range(4, 8)]]
    assert [[d.index for d in row] for row in grid.devices] == [[d.id for d in row]
                                                                for row in ref.devices]
    assert list(sequence_mesh(3, "cuda:0").devices) == [cuda(0)] * 3
    assert list(sequence_mesh(device=torch.device("cuda", 1)).devices) == [cuda(1)]
    assert list(sequence_mesh(device=[cuda(2), cuda(5)]).devices) == [cuda(2), cuda(5)]


def test_ranks_past_the_cards_spread_in_order(visible):
    """More ranks than cards: rank k on card k * c // n, so one card holds
    today's virtual ranks (chip_smoke's sequence_mesh(3) and grid_mesh(1, 8))."""
    visible(4)
    assert list(sequence_mesh(8).devices) == [cuda(k // 2) for k in range(8)]
    assert list(sequence_mesh(6).devices) == [cuda(k * 4 // 6) for k in range(6)]
    visible(1)
    assert list(sequence_mesh(3).devices) == [cuda(0)] * 3
    assert grid_mesh(1, 8).devices.tolist() == [[cuda(0)] * 8]
    assert sequence_mesh().shape == {"seq": 1}
    assert spread(["a", "b"], 5) == ["a", "a", "a", "b", "b"]


def test_launch_plan_is_one_launch_per_card():
    """B3's host-side grouping: one launch per card that holds shards, in the
    order of each card's first rank, with that card's ranks."""
    assert launch_plan([cuda(0)] * 3) == [(cuda(0), (0, 1, 2))]
    assert launch_plan([cuda(k // 2) for k in range(8)]) == [
        (cuda(k), (2 * k, 2 * k + 1)) for k in range(4)]
    assert launch_plan([cuda(1), cuda(0), cuda(1), cuda(2)]) == [
        (cuda(1), (0, 2)), (cuda(0), (1,)), (cuda(2), (3,))]
    assert launch_plan([cuda(0)] * 3, "per_shard") == [(cuda(0), (j,)) for j in range(3)]
    assert launch_plan([cuda(0), cuda(1)], "per_shard") == [(cuda(0), (0,)), (cuda(1), (1,))]
    with pytest.raises(ValueError, match="force_route"):
        launch_plan([cuda(0)], "ring")


def test_cpu_shards_take_the_plain_version_on_every_route():
    shards = [torch.arange(6.0).reshape(3, 2) + 10 * r for r in range(3)]
    for route in (None, "per_shard"):
        outs = ring_gather(shards, force_route=route)
        assert all(torch.equal(o, torch.cat(shards)) for o in outs)


@pytest.mark.parametrize("rc,match", [(-1, "cuda:0 cannot access cuda:1"),
                                      (217, "from cuda:0 to cuda:1 failed: cudaError 217")])
def test_cards_without_peer_access_raise(monkeypatch, rc, match):
    """B3 never falls back to copies: a pair of cards that cannot reach each
    other, or a failing cudaDeviceEnablePeerAccess, raises naming the pair
    (the kernel library's answer stood in for)."""
    monkeypatch.setattr(ring_exchange, "_PEERS", set())
    lib = types.SimpleNamespace(ring_gather_enable_peer=lambda a, b: rc)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    with pytest.raises(RuntimeError, match=match):
        ring_exchange.enable_peer_access([cuda(0), cuda(1)])
    assert ring_exchange._PEERS == set()


def test_ring_bound():
    """One rank per card: the link into a card bounds it, (num - 1) B at
    450 GB/s; ranks of one card: the memory, (num + num^2) B at 3.35 TB/s."""
    B = 7 * 16384 * 4
    assert multichip.ring_bound_ms([cuda(k) for k in range(4)], B) == pytest.approx(
        3 * B / 450e9 * 1e3)
    assert multichip.ring_bound_ms([cuda(k) for k in range(4)], 8 * B) == pytest.approx(
        0.0245, abs=1e-4)
    assert multichip.ring_bound_ms([cuda(0)] * 8, B) == pytest.approx(72 * B / 3.35e12 * 1e3)


def test_22_sequences_do_not_split_over_4_ranks():
    """The KITTI sweep's 22 sequences split over 2 ranks, not 4 (the
    reference's shard_map refuses that split too)."""
    assert len(tsw.sequence_devices(22, sequence_mesh(2, device="cpu"))) == 22
    with pytest.raises(ValueError, match="22 sequences not divisible by the 4 ranks"):
        tsw.sequence_devices(22, sequence_mesh(4, device="cpu"))


def _dryrun_cfg(C, H=64, W=96):
    """__graft_entry__.py:76-86 from config module `C`."""
    return C.PipelineConfig(
        camera=C.CameraConfig(fx=120.0, fy=120.0, cx=W / 2.0, cy=H / 2.0, height=H, width=W),
        tracker=C.TrackerConfig(num_levels=2, max_iterations=(4, 4), interp="bilinear",
                                depth_decimation="even"),
        depth=C.DepthConfig(block_rows=4, block_cols=8, min_valid_points=1, max_iters=4,
                            interp="bilinear"),
        keyframe=C.KeyframeConfig(),
    )


def _rows(lines):
    """(n, collective bytes, analytic efficiency) of a printed scaling table."""
    return [(int(f[0]), int(f[2]), float(f[3])) for f in (line.split() for line in lines)]


def test_dryrun_multichip_prints_the_references_lines(capsys):
    """The dry run on 8 virtual CPU ranks prints the reference's lines: the
    step line with the same pose shape and health, the table's sizes (the
    port counts dispatched operations where the reference reads XLA's
    FLOPs), and the verdict; every analytic row passes the >= 80% gate and
    moves a few bytes in both."""
    assert dataclasses.asdict(multichip.dryrun_config()) == dataclasses.asdict(_dryrun_cfg(jc))
    ge.dryrun_multichip(8)
    ref = capsys.readouterr().out.strip().splitlines()
    got = multichip.dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == ref[0] == "dryrun_multichip(8): step executed; poses (8, 4, 4), global_ok=True"
    assert out[-1] == ref[-1] == "dryrun_multichip(8): analytic weak-scaling >=80%: True"
    assert out[1].split()[0] == "n" and out[1].split()[2:] == ref[1].split()[2:]
    rows, ref_rows = _rows(out[2:-1]), _rows(ref[2:-1])
    assert [r[0] for r in rows] == [r[0] for r in ref_rows] == [1, 2, 4, 8]
    for n, nbytes, eff in rows + ref_rows:
        assert eff >= 80.0 and 0 < nbytes < 4096
    assert got["flat"] and got["global_ok"] and got["poses"].shape == (8, 4, 4)
    assert [r["n"] for r in got["rows"]] == [1, 2, 4, 8]


def test_one_process_per_rank_equals_one_process():
    """The per-process layout of the multi-card tool, on the CPU: two
    processes in a gloo group, one driving-family sequence each at 64x96,
    6 frames. Their poses equal one process's run_sweep on two ranks bit for
    bit, every frame is healthy in both, and the reference's run_sweep on
    two devices agrees within C1's tolerance."""
    cfg = multichip.dryrun_config()
    recs = multichip.per_process([[0], [1]], 6, device="cpu", config="dryrun", timeout=300)
    frames = [[tuple(a.numpy() for a in f) for f in fr]
              for _, fr in multichip.driving_runs([0, 1], 6, cfg, "cpu")]
    health = []
    one = tsw.run_sweep(frames, cfg, sequence_mesh(2, device="cpu"), device="cpu",
                        progress=lambda i, st, outs, ok: health.append(bool(ok)))
    np.testing.assert_array_equal(np.concatenate([r["poses"] for r in recs]), one)
    assert all(r["health"].all() and r["health"].shape == (6,) for r in recs) and all(health)
    assert all(r["promoted"].shape == (5, 1) and float(r["seconds"]) > 0 for r in recs)
    ref = jsw.run_sweep(frames, _dryrun_cfg(jc), jmesh.sequence_mesh(2))
    np.testing.assert_allclose(one, ref, rtol=0, atol=POSE_ATOL)


def test_the_tool_refuses_fewer_than_two_cards(capsys):
    assert multichip.main([]) == 1
    assert "needs 2 CUDA cards or more, 0 visible" in capsys.readouterr().err


def test_port_config_module_builds_the_dry_run_configuration():
    assert dataclasses.asdict(_dryrun_cfg(tc)) == dataclasses.asdict(multichip.dryrun_config())
