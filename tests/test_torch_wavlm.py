"""WavLM on the port's serving and extraction path (``models/wavlm.py``):
the plain reference (``tests/wavlm_reference.py``) against transformers'
``WavLMModel``, the port's batched encoder against the reference, the
relative position buckets, the biased attention's plain version, the
checkpoint converter, the CLI's dispatch on the architecture, and
(``cuda`` marker) the biased kernel on the card.

This file imports neither JAX nor the JAX package, so the card tests run
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_wavlm.py -s
"""

import hashlib
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import wavlm_reference as ref  # noqa: E402

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (  # noqa: E402
    cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (  # noqa: E402
    EncoderConfig,
    dad_preset,
    encoder_config,
    wavlm_large_config,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (  # noqa: E402
    convert,
    wavlm,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.extract import (  # noqa: E402
    FeatureExtractor,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops import (  # noqa: E402
    attention,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.utils import (  # noqa: E402
    profiling,
)

CONV = ((16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2), (16, 3, 2), (16, 2, 2), (16, 2, 2))
# a tiny WavLM: every part of the published one (7 conv layers with channel
# LayerNorms, an even positional kernel, gated relative bias, the layer sum)
TINY = dict(embed_dim=32, depth=2, num_heads=2, norm_eps=1e-5, mlp_ratio=2.0,
            conv_feature_layers=[list(c) for c in CONV], conv_pos_width=16, conv_pos_groups=4,
            num_buckets=320, max_bucket_distance=800)


def tiny_config(**kw) -> EncoderConfig:
    fields = dict(TINY, conv_feature_layers=CONV, dtype="float32", **kw)
    return wavlm_large_config(**fields)


def hf_state_dict(enc: dict, seed: int = 0, legacy_norm: bool = False,
                  layer_weights: bool = True) -> dict:
    """A seeded transformers-layout WavLM state dict: weights N(0, 1 /
    fan_in), biases and LayerNorm shifts N(0, 0.1^2), LayerNorm scales and
    the gate constants 1 + N(0, 0.1^2), the bucket embedding N(0, 1), the
    positional conv's weight norm (``weight_g``/``weight_v`` with
    ``legacy_norm``, else the parametrization's names)."""
    g = torch.Generator().manual_seed(seed)
    E, H, K = enc["embed_dim"], enc["num_heads"], enc["conv_pos_width"]
    hid = int(E * enc["mlp_ratio"])
    sd = {}

    def w(name, *shape):
        fan = int(np.prod(shape[1:]))
        sd[name] = torch.randn(shape, generator=g) / math.sqrt(fan)

    def vec(name, n, offset=0.0):
        sd[name] = offset + 0.1 * torch.randn(n, generator=g)

    in_c = 1
    for i, (dim, k, _s) in enumerate(enc["conv_feature_layers"]):
        pre = f"feature_extractor.conv_layers.{i}"
        w(f"{pre}.conv.weight", dim, in_c, k)
        vec(f"{pre}.layer_norm.weight", dim, 1.0)
        vec(f"{pre}.layer_norm.bias", dim)
        in_c = dim
    vec("feature_projection.layer_norm.weight", in_c, 1.0)
    vec("feature_projection.layer_norm.bias", in_c)
    w("feature_projection.projection.weight", E, in_c)
    vec("feature_projection.projection.bias", E)
    pos = "encoder.pos_conv_embed.conv."
    gname, vname = ((f"{pos}weight_g", f"{pos}weight_v") if legacy_norm else
                    (f"{pos}parametrizations.weight.original0",
                     f"{pos}parametrizations.weight.original1"))
    sd[gname] = math.sqrt(E / K) * (1 + 0.1 * torch.randn(1, 1, K, generator=g))
    sd[vname] = torch.randn(E, E // enc["conv_pos_groups"], K, generator=g)
    vec(f"{pos}bias", E)
    sd["encoder.layers.0.attention.rel_attn_embed.weight"] = torch.randn(
        enc["num_buckets"], H, generator=g)
    for i in range(enc["depth"]):
        pre = f"encoder.layers.{i}"
        for n in ("q", "k", "v", "out"):
            w(f"{pre}.attention.{n}_proj.weight", E, E)
            vec(f"{pre}.attention.{n}_proj.bias", E)
        w(f"{pre}.attention.gru_rel_pos_linear.weight", 8, E // H)
        vec(f"{pre}.attention.gru_rel_pos_linear.bias", 8)
        sd[f"{pre}.attention.gru_rel_pos_const"] = 1 + 0.1 * torch.randn(1, H, 1, 1, generator=g)
        for n in ("layer_norm", "final_layer_norm"):
            vec(f"{pre}.{n}.weight", E, 1.0)
            vec(f"{pre}.{n}.bias", E)
        w(f"{pre}.feed_forward.intermediate_dense.weight", hid, E)
        vec(f"{pre}.feed_forward.intermediate_dense.bias", hid)
        w(f"{pre}.feed_forward.output_dense.weight", E, hid)
        vec(f"{pre}.feed_forward.output_dense.bias", E)
    vec("encoder.layer_norm.weight", E, 1.0)
    vec("encoder.layer_norm.bias", E)
    if layer_weights:
        sd["layer_weights"] = torch.randn(enc["depth"] + 1, generator=g)
    return sd


def _hf_bucket(r: int, num_buckets: int = 320, max_distance: int = 800) -> int:
    """transformers' formula for one relative position, in Python floats
    where it uses float32 (no value here lies near a bucket's edge)."""
    half = num_buckets // 2
    exact = half // 2
    b = half if r > 0 else 0
    r = abs(r)
    if r < exact:
        return b + r
    large = exact + int(math.log(r / exact) / math.log(max_distance / exact) * (half - exact))
    return b + min(large, half - 1)


# ---------------------------------------------------------------------------
# (a) the reference against transformers
# ---------------------------------------------------------------------------

def test_reference_matches_transformers_wavlm_model():
    mw = pytest.importorskip("transformers.models.wavlm.modeling_wavlm")
    config = pytest.importorskip("transformers.models.wavlm.configuration_wavlm")
    hc = config.WavLMConfig(
        hidden_size=TINY["embed_dim"], num_hidden_layers=TINY["depth"],
        num_attention_heads=TINY["num_heads"],
        intermediate_size=int(TINY["embed_dim"] * TINY["mlp_ratio"]),
        conv_dim=[c[0] for c in CONV], conv_kernel=[c[1] for c in CONV],
        conv_stride=[c[2] for c in CONV], feat_extract_norm="layer", do_stable_layer_norm=True,
        conv_bias=False, num_conv_pos_embeddings=TINY["conv_pos_width"],
        num_conv_pos_embedding_groups=TINY["conv_pos_groups"], layer_norm_eps=1e-5,
        hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0, mask_time_prob=0.0,
        hidden_act="gelu", feat_extract_activation="gelu")
    model = mw.WavLMModel(hc).eval()
    sd = hf_state_dict(TINY, seed=1, layer_weights=False)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert unexpected == [] and set(missing) <= {"masked_spec_embed"}
    wav = torch.randn(1, 40000, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out = model(wav, output_hidden_states=True)
    states, weighted = ref.hidden_states(sd, TINY, wav[0])
    assert len(states) == len(out.hidden_states) == TINY["depth"] + 1
    # float32 round-off: the two take the same operations in other orders
    for want, got in zip(out.hidden_states, states):
        torch.testing.assert_close(got, want[0], atol=2e-5, rtol=2e-5)
    uniform = sum(out.hidden_states)[0] / len(states)  # no layer_weights: 1/25 each
    torch.testing.assert_close(weighted, uniform, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# (b) the port's batched, bucket-padded encoder against the reference
# ---------------------------------------------------------------------------

def test_batched_encoder_matches_reference_clip_by_clip():
    cfg = tiny_config()
    sd = hf_state_dict(TINY, seed=3)
    extractor = FeatureExtractor(cfg, convert.hf_wavlm_to_torch_encoder(sd, cfg), batch_size=4,
                                 buckets=(16000, 32000), device="cpu")
    g = np.random.default_rng(4)
    clips = [g.standard_normal(n).astype(np.float32) for n in (31000, 17123, 5000)]
    lo = len(profiling.spans())
    feats = extractor.extract_clips(clips)
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.emotion2vec import (
        normalize_wav,
    )
    for clip, got in zip(clips, feats):
        want = ref.hidden_states(sd, TINY, normalize_wav(torch.from_numpy(clip)))[1]
        assert got.shape == tuple(want.shape)
        # float32 on both sides, the batch padded to a 2 s bucket: round-off
        torch.testing.assert_close(torch.from_numpy(got), want, atol=1e-5, rtol=1e-5)
    enc = [s for s in profiling.spans()[lo:] if s.name == "wavlm.encoder"]
    assert len(enc) == 1 and enc[0].attrs["rows"] == 4 and enc[0].attrs["frames"] == 99
    assert enc[0].attrs == {"rows": 4, "frames": 99}  # shapes only: nothing read back
    assert any(s.name == "wavlm.position_bias" for s in profiling.spans()[lo:])


def test_padded_frames_do_not_reach_valid_ones():
    """A clip alone and the same clip beside a longer one agree on its
    frames: padded frames are zeroed before the positional conv and masked
    as keys."""
    cfg = tiny_config()
    with torch.device("cpu"):
        model = wavlm.WavLMEncoder(cfg)
    model.load_state_dict(convert.hf_wavlm_to_torch_encoder(hf_state_dict(TINY, seed=5), cfg))
    g = torch.Generator().manual_seed(6)
    a, b = torch.randn(9000, generator=g), torch.randn(20000, generator=g)
    wav = torch.zeros(2, 20000)
    wav[0, :9000], wav[1] = a, b
    mask = torch.arange(20000)[None, :] >= torch.tensor([9000, 20000])[:, None]
    with torch.no_grad():
        both, fm = model(wav, mask)
        alone, _ = model(a[None])
    n = alone.shape[1]
    assert bool(fm[0, n:].all()) and not bool(fm[0, :n].any())
    torch.testing.assert_close(both[0, :n], alone[0], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) the buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [0, 1, -1, 79, -79, 80, -80, 799, -799, 800, -800, 1498, -1498])
def test_relative_buckets_match_transformers_formula(r):
    got = int(wavlm.relative_buckets(torch.tensor([r]))[0])
    assert got == _hf_bucket(r) == int(ref.buckets(torch.tensor([r]))[0])


def test_position_table_reads_the_bucket_embedding():
    embed = torch.randn(320, 3, generator=torch.Generator().manual_seed(7))
    n = 1499
    table = wavlm.position_table(embed, n, 320, 800)
    assert table.shape == (3, 2 * n - 1) and table.is_contiguous()
    for r in (-1498, -800, -80, -1, 0, 1, 79, 713, 1498):
        torch.testing.assert_close(table[:, r + n - 1], embed[_hf_bucket(r)], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# (d) the biased attention's CPU path against the materialised formula
# ---------------------------------------------------------------------------

def _biased_inputs(B, H, N, lengths, dtype=torch.float32, device="cpu", seed=0):
    """The encoder's strided q, k, v views, a (H, 2N - 1) table of N(0, 1)
    and the (B, H, N) gate as the transpose view of a (B, N, H) buffer,
    values in [1, 3), its range in WavLM."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, N, 3, H, 64, generator=g).to(device, dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    table = torch.randn(H, 2 * N - 1, generator=g).to(device)
    gate = (1 + 2 * torch.rand(B, N, H, generator=g)).to(device).transpose(1, 2)
    mask = (torch.arange(N)[None, :] >= torch.tensor(lengths)[:, None]).to(device)
    return q, k, v, mask, table, gate


def test_cpu_biased_attention_matches_materialised_formula():
    B, H, N = 3, 2, 37
    q, k, v, mask, table, gate = _biased_inputs(B, H, N, [37, 20, 5])
    before = (attention.flash_attention.launches, attention.flash_attention.biased_launches)
    out = attention.flash_attention(q, k, v, mask, 0.125, rel_bias=(table, gate))
    assert (attention.flash_attention.launches,
            attention.flash_attention.biased_launches) == before  # the CPU counts nothing
    s = q.double() @ k.double().transpose(-1, -2) * 0.125
    for qi in range(N):
        for ki in range(N):
            s[:, :, qi, ki] += gate[:, :, qi].double() * table[:, ki - qi + N - 1].double()
    s = s.masked_fill(mask[:, None, None, :], float("-inf"))
    want = torch.softmax(s, -1) @ v.double()
    torch.testing.assert_close(out.double(), want, atol=2e-6, rtol=0)
    assert out.transpose(1, 2).is_contiguous()


def test_rel_bias_argument_checks():
    q, k, v, mask, table, gate = _biased_inputs(2, 2, 9, [9, 4])
    with pytest.raises(ValueError, match="table"):
        attention.flash_attention(q, k, v, mask, rel_bias=(table[:, :-1], gate))
    with pytest.raises(ValueError, match="gate"):
        attention.flash_attention(q, k, v, mask, rel_bias=(table, gate.double()))
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention(q, k, v, mask, rel_bias=(table.t().contiguous().t(), gate))


# ---------------------------------------------------------------------------
# (e) the converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("legacy_norm", [True, False])
def test_converter_folds_weight_norm_and_fuses_qkv(legacy_norm):
    cfg = tiny_config()
    sd = hf_state_dict(TINY, seed=8, legacy_norm=legacy_norm)
    out = convert.hf_wavlm_to_torch_encoder({f"wavlm.{k}": v for k, v in sd.items()}, cfg)
    pos = "encoder.pos_conv_embed.conv."
    g, v = ((sd[f"{pos}weight_g"], sd[f"{pos}weight_v"]) if legacy_norm else
            (sd[f"{pos}parametrizations.weight.original0"],
             sd[f"{pos}parametrizations.weight.original1"]))
    torch.testing.assert_close(out["pos_conv.weight"],
                               g * v / v.norm(dim=(0, 1), keepdim=True), atol=1e-6, rtol=1e-6)
    a = "encoder.layers.1.attention."
    assert torch.equal(out["layer_1.attn.qkv.weight"], torch.cat(
        [sd[f"{a}{n}_proj.weight"] for n in "qkv"]))
    assert torch.equal(out["layer_1.attn.gate_const"], sd[f"{a}gru_rel_pos_const"].view(-1))
    assert torch.equal(out["rel_attn_embed"], sd["encoder.layers.0.attention.rel_attn_embed.weight"])
    assert torch.equal(out["layer_weights"], sd["layer_weights"])


def test_converter_audits_keys_and_defaults_the_layer_weights():
    cfg = tiny_config()
    sd = hf_state_dict(TINY, seed=9, layer_weights=False)
    dead = dict(sd, masked_spec_embed=torch.zeros(32), **{"projector.weight": torch.zeros(2, 32)})
    out = convert.hf_wavlm_to_torch_encoder(dead, cfg)
    assert torch.equal(out["layer_weights"], torch.zeros(TINY["depth"] + 1))
    with pytest.raises(ValueError, match="does not recognize"):
        convert.hf_wavlm_to_torch_encoder(dict(sd, **{"encoder.extra": torch.zeros(1)}), cfg)
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.hf_wavlm_to_torch_encoder(sd, tiny_config(mlp_ratio=4.0))


def test_loader_reads_torch_and_safetensors_files(tmp_path):
    cfg = tiny_config()
    sd = hf_state_dict(TINY, seed=10)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    a = convert.load_encoder_checkpoint(str(tmp_path / "pytorch_model.bin"), cfg)
    st = pytest.importorskip("safetensors.torch")
    st.save_file({k: v.contiguous() for k, v in sd.items()}, str(tmp_path / "model.safetensors"))
    b = convert.load_encoder_checkpoint(str(tmp_path / "model.safetensors"), cfg)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_wavlm_refuses_tensor_parallelism():
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel.fused import (
        frozen_encoder,
    )

    class Mesh:
        tp, tp_group = 2, object()

    with pytest.raises(ValueError, match="tensor-parallel"):
        frozen_encoder(tiny_config(), {}, "cpu", Mesh())


# ---------------------------------------------------------------------------
# (f) the CLI's dispatch on the architecture
# ---------------------------------------------------------------------------

def test_encoder_json_arch_starts_from_wavlm_large():
    cfg = encoder_config('{"arch": "wavlm"}')
    assert (cfg.arch, cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.norm_eps) == (
        "wavlm", 1024, 24, 16, 1e-5)
    assert (cfg.conv_pos_width, cfg.conv_pos_groups, cfg.use_flash_attention) == (128, 16, True)
    assert encoder_config().arch == "emotion2vec"
    assert dad_preset("iemocap", input_dim=cfg.embed_dim).input_dim == 1024
    assert dad_preset("iemocap").input_dim == 768


def test_cli_extract_runs_a_wavlm_checkpoint(tmp_path):
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.audio.wavio import (
        write_wav,
    )

    torch.save(hf_state_dict(TINY, seed=11), tmp_path / "wavlm.bin")
    (tmp_path / "wav").mkdir()
    g = np.random.default_rng(12)
    rows = []
    for i, n in enumerate((12000, 7000)):
        write_wav(str(tmp_path / "wav" / f"c{i}.wav"),
                  (0.1 * g.standard_normal(n)).astype(np.float32), 16000)
        rows.append(f"c{i}.wav\t{n}")
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "train.tsv").write_text(str(tmp_path / "wav") + "\n" + "\n".join(rows) + "\n")
    enc = json.dumps(dict(TINY, arch="wavlm", dtype="float32"))
    rc = cli.main(["extract", "--data", str(tmp_path / "m"), "--checkpoint",
                   str(tmp_path / "wavlm.bin"), "--save-dir", str(tmp_path / "f"),
                   "--encoder-json", enc, "--batch-size", "2", "--device", "cpu"])
    assert rc == 0
    feats = np.load(tmp_path / "f" / "train.npy")
    lengths = [int(x) for x in (tmp_path / "f" / "train.lengths").read_text().split()]
    assert feats.shape == (sum(lengths), TINY["embed_dim"]) and lengths == [37, 21]


def zero_head(E: int, h: int = 256) -> dict:
    """A DAD head of input ``E`` in the reference SSRL layout, all zeros."""
    return {f"{role}_{k}": torch.zeros(shape) for role in ("student", "teacher")
            for k, shape in (("encoder.pre_net.weight", (h, E)), ("encoder.pre_net.bias", (h,)),
                             ("classifier.fc_layer.weight", (4, h)),
                             ("classifier.fc_layer.bias", (4,)))}


def test_cli_serve_builds_a_wavlm_predictor(tmp_path, monkeypatch):
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.eval import (
        serving,
    )

    torch.save(hf_state_dict(TINY, seed=13), tmp_path / "wavlm.bin")
    E = TINY["embed_dim"]
    torch.save(zero_head(E), tmp_path / "dad.pth")
    built = {}
    monkeypatch.setattr(serving.PredictionServer, "serve_forever",
                        lambda self: built.setdefault("predictor", self.predictor))
    enc = json.dumps(dict(TINY, arch="wavlm", dtype="float32"))
    rc = cli.main(["serve", "--weights", str(tmp_path / "dad.pth"), "--checkpoint",
                   str(tmp_path / "wavlm.bin"), "--encoder-json", enc, "--no-warmup",
                   "--device", "cpu", "--port", "0"])
    assert rc == 0
    predictor = built["predictor"]
    assert isinstance(predictor.extractor.model, wavlm.WavLMEncoder)
    assert predictor.cfg.input_dim == E
    out = predictor.predict_wavs([np.zeros(8000, np.int16) + 5])
    assert abs(sum(out[0]["probs"].values()) - 1) < 1e-5


def test_serving_assembly_records_each_clip_length():
    """On the wav path the ``serving.assemble`` span holds each row's
    samples, the lengths the host padded the batch from, in row order; the
    encoder span inside the same batch holds its shapes."""
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.eval.serving import (
        EmotionPredictor,
    )

    cfg = tiny_config()
    sd = convert.hf_wavlm_to_torch_encoder(hf_state_dict(TINY, seed=17), cfg)
    extractor = FeatureExtractor(cfg, sd, batch_size=4, buckets=(16000, 32000), device="cpu")
    predictor = EmotionPredictor(dad_preset("iemocap", input_dim=cfg.embed_dim),
                                 convert.torch_state_dict_to_ssrl(zero_head(cfg.embed_dim)),
                                 extractor=extractor, batch_size=4, device="cpu")
    lo = len(profiling.spans())
    predictor.predict_wavs([np.ones(n, np.int16) for n in (20000, 9000, 31000)])
    spans = profiling.spans()[lo:]
    (assemble,) = [s for s in spans if s.name == "serving.assemble"]
    (enc,) = [s for s in spans if s.name == "wavlm.encoder"]
    assert assemble.attrs == {"samples": (9000, 20000, 31000)}
    assert assemble.end <= enc.start and enc.attrs == {"rows": 4, "frames": 99}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """Skips unless a CUDA device is present, decided at run time so that
    every pytest-xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: pytest --noconftest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# biased kernel vs the plain f32 formula on items with a valid key. f32:
# summation order (the table entry and the gate enter once, in f32, as in
# the formula). bf16: the unbiased kernel's tolerance and reason, two bf16
# ulps of the output: the plain version rounds p to bf16 after normalising,
# the kernel before (online softmax); the bias itself is added in f32 on
# both sides.
TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 499, 799, 1499])
def test_biased_kernel_matches_plain_on_gpu(cuda_device, dtype, N):
    """B 16, H 16: full, padded and one all-padded (filler) item."""
    g = torch.Generator().manual_seed(N)
    lengths = torch.randint(1, N + 1, (16,), generator=g)
    lengths[0], lengths[-1] = N, 0
    q, k, v, mask, table, gate = _biased_inputs(16, 16, N, lengths.tolist(), dtype,
                                                cuda_device, seed=N)
    before = (attention.flash_attention.launches, attention.flash_attention.biased_launches)
    out = attention.flash_attention(q, k, v, mask, 0.125, rel_bias=(table, gate))
    torch.cuda.synchronize()
    assert (attention.flash_attention.launches,
            attention.flash_attention.biased_launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and torch.isfinite(out).all()
    want = attention.flash_attention_reference(q, k, v, mask, 0.125, (table, gate))
    rows = (lengths > 0).to(cuda_device)
    torch.testing.assert_close(out[rows].float(), want[rows].float(), **TOL[dtype])
    assert (out[~rows] == 0).all()  # every key padded: written as 0


# sha256 of the unbiased bf16 kernel's output on _golden_inputs(), taken on
# an H100 80GB HBM3 from the kernel as it was before the biased variant was
# added (its library built from that source and called directly)
UNBIASED_GOLDEN = "4b40d526d78e34f17a4c63b0fb7ffa396e0ffac70d1f0f67eeeb5bfe8819ea98"


def _golden_inputs(device):
    g = torch.Generator().manual_seed(2024)
    qkv = torch.randn(16, 1499, 3, 12, 64, generator=g).to(device, torch.bfloat16)
    lengths = torch.randint(1, 1500, (16,), generator=g)
    lengths[0], lengths[-1] = 1499, 0
    mask = (torch.arange(1499)[None, :] >= lengths[:, None]).to(device)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3)) + (mask,)


def unbiased_digest(device) -> str:
    q, k, v, mask = _golden_inputs(device)
    out = attention.flash_attention(q, k, v, mask, 0.125)
    return hashlib.sha256(out.transpose(1, 2).contiguous().view(torch.int16).cpu()
                          .numpy().tobytes()).hexdigest()


@pytest.mark.cuda
def test_unbiased_kernel_output_is_unchanged_on_gpu(cuda_device):
    assert unbiased_digest(cuda_device) == UNBIASED_GOLDEN


def _wavlm_large(dtype, depth):
    cfg = wavlm_large_config(depth=depth, dtype=dtype)
    enc = dict(embed_dim=1024, depth=depth, num_heads=16, norm_eps=1e-5, mlp_ratio=4.0,
               conv_feature_layers=cfg.conv_feature_layers, conv_pos_width=128,
               conv_pos_groups=16, num_buckets=320, max_bucket_distance=800)
    sd = hf_state_dict(enc, seed=14)
    return cfg, enc, sd


@pytest.mark.cuda
def test_wavlm_large_launches_the_biased_kernel_in_every_layer_on_gpu(cuda_device):
    """WavLM Large through FeatureExtractor: 24 biased launches a batch and
    no plain attention; in f32 (the f32 kernel) every clip matches the plain
    reference to 1e-4 of its largest feature (summation order through 24
    layers)."""
    g = np.random.default_rng(15)
    clips = [g.standard_normal(n).astype(np.float32) for n in (64000, 41000, 9000)]
    for dtype in ("bfloat16", "float32"):
        cfg, enc, sd = _wavlm_large(dtype, 24)
        ex = FeatureExtractor(cfg, convert.hf_wavlm_to_torch_encoder(sd, cfg), batch_size=4,
                              buckets=(64000, 128000), device=cuda_device)
        before = (attention.flash_attention.launches, attention.flash_attention.biased_launches)
        feats = ex.extract_clips(clips)
        after = (attention.flash_attention.launches, attention.flash_attention.biased_launches)
        assert after[1] - before[1] == 24 and after[0] - before[0] == 24
        if dtype == "float32":
            from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.emotion2vec import (
                normalize_wav,
            )
            dev_sd = {k: v.to(cuda_device) for k, v in sd.items()}
            for clip, got in zip(clips, feats):
                x = normalize_wav(torch.from_numpy(clip).to(cuda_device))
                want = ref.hidden_states(dev_sd, enc, x)[1].cpu()
                err = float((torch.from_numpy(got) - want).abs().max() / want.abs().max())
                assert err < 1e-4, err
        del ex
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_biased_kernel_timing_on_gpu(cuda_device):
    """Device ms at serving's 30 s bucket (B 16, H 16, N 1499, the encoder's
    strided views, a padded batch), cold L2, in turns: unbiased, biased,
    biased, unbiased; the plain biased path by events around eager calls.
    Prints one JSON line (run with -s) for PERF.md; asserts nothing of
    speed."""
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.utils import (
        timing,
    )

    B, H, N = 16, 16, 1499
    g = torch.Generator().manual_seed(16)
    lengths = torch.randint(N // 4, N + 1, (B,), generator=g)
    lengths[0] = N
    per_set = B * N * 3 * H * 64 * 2 + B * N * H * 64 * 2
    sets = [_biased_inputs(B, H, N, lengths.tolist(), torch.bfloat16, cuda_device, seed=s)
            for s in range(timing.rotation(per_set))]

    def unbiased(s):
        return lambda: attention.flash_attention(s[0], s[1], s[2], s[3], 0.125)

    def biased(s):
        return lambda: attention.flash_attention(s[0], s[1], s[2], s[3], 0.125, (s[4], s[5]))

    turns = []
    for kind in ("unbiased", "biased", "biased", "unbiased"):
        make = unbiased if kind == "unbiased" else biased
        turns.append((kind, timing.device_ms([make(s) for s in sets], cold=True)))
    s = sets[0]
    plain = timing.call_ms(lambda: attention.flash_attention_reference(
        s[0], s[1], s[2], s[3], 0.125, (s[4], s[5])), iters=5, warmup=1)
    ms = {k: [t for kk, t in turns if kk == k] for k in ("unbiased", "biased")}
    print(json.dumps({"relbias_kernel": {"B": B, "H": H, "N": N,
                                         "valid_keys": int(lengths.sum()),
                                         "device_ms_cold": ms, "plain_call_ms": plain,
                                         "card": torch.cuda.get_device_name()}}), flush=True)
    assert all(t > 0 for _k, t in turns) and plain > 0
