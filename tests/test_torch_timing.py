"""The port's timing helpers (``utils/timing.py``) on the CPU: how many
input sets a cold rotation needs, the host clock, the clock sampler, and
that every device measure refuses to run without a CUDA device rather than
report a CPU time under a device name."""

import shutil
import time

import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.utils import (
    timing,
)


@pytest.mark.parametrize("set_bytes, sets", [
    (1, timing.COLD_BYTES), (58_687_488, 4), (39_124_992, 6), (419_299_328, 2),
    (timing.COLD_BYTES, 2), (0, timing.COLD_BYTES),
])
def test_rotation_moves_more_than_the_cold_bytes(set_bytes, sets):
    assert timing.rotation(set_bytes) == sets
    assert sets >= 2 and sets * max(1, set_bytes) >= timing.COLD_BYTES


def test_host_seconds_is_the_mean_of_the_calls():
    calls = []
    seconds = timing.host_seconds(lambda: (calls.append(1), time.sleep(0.002)), iters=3)
    assert len(calls) == 4 and 0.002 <= seconds < 0.5  # one warm-up call


@pytest.mark.parametrize("measure", [
    lambda fn: timing.device_ms([fn], cold=True),
    lambda fn: timing.call_ms(fn),
    lambda fn: timing.host_us(fn),
])
def test_device_measures_need_a_card(measure):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    calls = []
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        measure(lambda: calls.append(1))
    assert calls == []  # refused before running anything


def test_clock_sampler_stops_its_child_and_reports_its_window():
    with timing.ClockSampler(interval_ms=50) as clocks:
        t0 = time.perf_counter()
        time.sleep(0.3)
        t1 = time.perf_counter()
    assert clocks._proc is None or clocks._proc.poll() is not None
    got = clocks.summary(t0, t1)
    if shutil.which("nvidia-smi") is None:
        assert got is None and clocks.samples == []
    elif got is not None:
        assert set(got) == {"samples", "sm_mhz", "mem_mhz", "power_w", "temp_c"}
    assert clocks.summary(t1 + 1.0) is None
