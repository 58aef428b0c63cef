"""The port's dry run of every process-grid path
(``parallel/dryrun.py::dryrun_multichip``, the counterpart of
``__graft_entry__.py``'s): four gloo processes on the CPU as a (2, 2) grid
pass all six stages, each with finite losses, and rank 0 prints a line a
stage. In a file of its own, so that xdist gives it a worker of its own."""

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
)

STAGES = (
    "fused extract+train step (2 steps, dp x tp)",
    "cached-clean + NOISEX-bank fused step",
    "d2v sharded pretrain step",
    "resident fused step (2 steps)",
    "fused trainer: startup, 2 epochs, noisy validation",
    "d2v driver over the grid (2 updates, guards, checkpoint, export)",
)


def test_dryrun_multichip_passes_six_stages_on_a_2x2_grid(capfd):
    stages = dryrun_multichip(4, timeout=240.0)
    assert tuple(name for name, _s, _t in stages) == STAGES
    assert all(s >= 0 for _n, s, _t in stages)
    out = capfd.readouterr().out
    for name in STAGES:
        assert f"[dryrun] stage '{name}' done in" in out, name
    assert "dryrun_multichip OK: mesh=(2x2) devices=4" in out
