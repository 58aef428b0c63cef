"""The yardstick's arithmetic against hand-worked cases: roofline bounds,
FLOP counts, percentiles, spreads, trace reduction and the readers."""

import math

import pytest

from benchmark.lib import readers, roofline, stats
from benchmark.lib.spans import Spans
from benchmark.lib.trace import TraceData


def test_bound_takes_the_larger_side():
    # 3.35e9 bytes take 1 ms; 989e9 operations take 1 ms
    assert roofline.bound_s(3.35e9, 0.0) == (pytest.approx(1e-3), "bytes")
    assert roofline.bound_s(0.0, 2 * 989e9) == (pytest.approx(2e-3), "operations")


def test_attention_bound_hand_case():
    # B 1, H 2, N 4, D 8, 3 valid keys: 4*2*4*8*3 = 768 FLOP; bytes 4*1*2*4*8*2 + 4 = 516
    got = roofline.attention_bound_s(1, 2, 4, 8, 3, itemsize=2)
    assert got == pytest.approx(max(516 / 3.35e12, 768 / 989e12))


def test_conv_frames_of_the_base_front_end():
    layers = [[512, 10, 5]] + [[512, 3, 2]] * 4 + [[512, 2, 2]] * 2
    assert roofline.conv_frames(16000, layers) == 49
    assert roofline.conv_frames(160000, layers) == 499
    assert roofline.conv_frames(300, layers) == 0


ENC = dict(embed_dim=4, mlp_ratio=2.0, conv_feature_layers=[[2, 2, 2]], conv_pos_width=3,
           conv_pos_depth=1, conv_pos_groups=2, prenet_depth=0, depth=1)


def test_encoder_flops_hand_case():
    # 6 samples -> 3 frames of 2 channels: conv 2*3*2*1*2 = 24; proj 2*3*2*4 = 48;
    # positional conv k 3, 2 in-channels a group: 2*3*4*2*3 = 144;
    # block: dense 2*(4*12 + 16 + 2*4*8) = 256 a frame, attention 2*2*3*4 = 48 a frame
    assert roofline.encoder_flops(ENC, 6) == 24 + 48 + 144 + 3 * (256 + 48)
    assert roofline.encoder_flops(ENC, 1) == 0.0


def test_head_flops_hand_case():
    assert roofline.head_flops(dict(input_dim=4, hidden_dim=3, num_classes=2), 5) == 2 * 5 * 12 + 2 * 6


def test_d2v_step_flops_hand_case():
    d2v = dict(clone_batch=2, crop_size=6,
               decoder=dict(decoder_layers=1, decoder_dim=2, decoder_groups=1, decoder_kernel=1))
    front = 2 * 3 * 2 * 1 * 2 + 2 * 3 * 2 * 4  # conv + projection, one clip
    pos = 144
    blocks = lambda n: n * (256 + 2 * 2 * n * 4)  # noqa: E731
    dec = 2 * 3 * 2 * 4 * 1 + 2 * 3 * 2 * 4
    want = 3 * front + (pos + blocks(3)) + 3 * 2 * (pos + blocks(1) + dec)
    assert roofline.d2v_step_flops(ENC, d2v, batch=1, frames=3, keep=1) == want


def test_percentile_is_nearest_rank_over_every_request():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    # a failed request counts above any limit
    assert stats.percentile([1.0] * 94 + [math.inf] * 6, 95) == math.inf
    assert stats.percentile([1.0] * 95 + [math.inf] * 5, 95) == 1.0


def test_spread_uses_statistics_quartiles():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def trace():
    ops = [("kernel", "a", 1.0, 2.0), ("kernel", "b", 1.5, 2.5), ("gpu_memcpy", "copy", 4.0, 4.5),
           ("kernel", "attn_fwd", 6.0, 7.0)]
    return TraceData(ops, (0.0, 10.0))


def test_trace_union_and_gaps():
    td = trace()
    assert td.busy_intervals() == [(1.0, 2.5), (4.0, 4.5), (6.0, 7.0)]
    assert td.busy_s == pytest.approx(3.0)
    assert td.gaps() == [(0.0, 1.0), (2.5, 4.0), (4.5, 6.0), (7.0, 10.0)]
    assert len(td.kernels()) == 3 and len(td.kernels("attn")) == 1


def test_trace_breakdown_names_gaps_by_host_span():
    sp = Spans()
    sp.add("wait", 0.0, 1.2)
    sp.add("step", 2.0, 6.5)
    td = trace()
    idle = dict(td.idle_by_span(sp))
    assert idle == {"wait": pytest.approx(1.0), "step": pytest.approx(3.0),
                    "host: outside any span": pytest.approx(3.0)}
    assert td.top_ops(2) == [["a", 1.0], ["b", 1.0]]


class Ctx:
    def __init__(self, td=None, **counters):
        self.trace_data, self.counters = td, counters


def test_readers_arithmetic():
    assert readers.device_idle_pct(Ctx(trace())) == pytest.approx(70.0)
    assert readers.device_idle_pct(Ctx(None)) is None
    assert readers.launches_per_step(Ctx(trace(), traced_steps=3)) == pytest.approx(1.0)
    assert readers.mfu_pct(989e12, 2.0) == pytest.approx(50.0)
    assert readers.mfu_pct(0.0, 2.0) is None
    assert readers.ratio_pct(1, 4) == 25.0 and readers.ratio_pct(1, 0) is None


def test_attention_roofline_reader_matches_kernels_to_calls():
    from benchmark.lib.harness import load_reader

    td = trace()  # one attn_fwd kernel, 1 s, inside the second call
    ctx = Ctx(td, calls=[(0.0, 5.0, 0.1), (5.5, 8.0, 0.25)])
    assert load_reader("attn_roofline.serve").read(ctx) == pytest.approx(25.0)
    assert load_reader("attn_roofline.serve").read(Ctx(None, calls=[])) is None
