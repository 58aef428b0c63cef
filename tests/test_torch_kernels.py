"""The port's kernel wrappers on their own (attention, fused LayerNorm,
row copy, conv + LN + GELU): input checks and the plain versions on the
CPU, and (``cuda`` marker) each Hopper kernel against its plain version on
the card.

This file imports neither JAX nor the JAX package, so the card tests run
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    EncoderConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.emotion2vec import (
    Emotion2vecEncoder,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops import (
    attention,
    conv,
    fused_norm,
    norm_probe,
)

# kernel vs plain on items with a valid key: f32 differs by summation order
# only; bf16 by two bf16 ulps (the plain version rounds p after normalising,
# the kernel before: online softmax)
TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}


@pytest.fixture
def cuda_device():
    """Skips unless a CUDA device is present, decided at run time so that
    every pytest-xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: pytest --noconftest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, H, N, lengths, dtype=torch.float32, device="cpu", seed=0, D=64):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, N, D, generator=g) for _ in range(3))
    mask = torch.arange(N)[None, :] >= torch.tensor(lengths)[:, None]
    q, k, v = ((t * (D**-0.5 if i == 0 else 1.0)).to(device, dtype).contiguous()
               for i, t in enumerate((q, k, v)))
    return q, k, v, mask.to(device)


def _encoder_views(B, H, N, dtype=torch.float32, device="cpu", seed=0, D=64):
    """q, k, v as the encoder passes them: (B, H, N, D) views of one
    (B, N, 3, H, D) projection output, q not pre-scaled."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, N, 3, H, D, generator=g).to(device, dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def test_reference_fully_masked_row_is_finite_uniform():
    q, k, v, mask = _inputs(1, 1, 10, [0], D=8)
    out = attention.flash_attention_reference(q, k, v, mask)
    # like the TPU kernel: the mask value swallows the scores, p is uniform
    torch.testing.assert_close(out[0, 0], v[0, 0].mean(0).expand(10, 8), atol=1e-6, rtol=0)


def test_reference_matches_float64_softmax():
    q, k, v, mask = _inputs(2, 3, 37, [37, 20], D=16)
    out = attention.flash_attention_reference(q, k, v, mask)
    s = q.double() @ k.double().transpose(-1, -2)
    s = s.masked_fill(mask[:, None, None, :], float("-inf"))
    want = torch.softmax(s, -1) @ v.double()
    torch.testing.assert_close(out.double(), want, atol=2e-6, rtol=0)


def test_cpu_runs_the_plain_version_without_counting():
    q, k, v, mask = _inputs(2, 2, 9, [9, 4])
    before = attention.flash_attention.launches
    out = attention.flash_attention(q, k, v, mask)
    assert attention.flash_attention.launches == before
    torch.testing.assert_close(out, attention.flash_attention_reference(q, k, v, mask))


def test_strided_views_match_contiguous_copies_and_output_layout():
    """The encoder's views give what contiguous copies give, and the output
    is the transpose view of a contiguous (B, N, H, D) buffer."""
    q, k, v = _encoder_views(2, 3, 21, seed=3)
    mask = torch.arange(21)[None, :] >= torch.tensor([21, 9])[:, None]
    out = attention.flash_attention(q, k, v, mask, scale=0.125)
    want = attention.flash_attention(*(t.contiguous() for t in (q, k, v)), mask, scale=0.125)
    assert torch.equal(out, want)
    for t in (out, want):
        assert t.shape == (2, 3, 21, 64) and t.transpose(1, 2).is_contiguous()
    assert out.transpose(1, 2).reshape(2, 21, 3 * 64).data_ptr() == out.data_ptr()


def test_scale_on_scores_equals_prescaled_q():
    """scale = 2^-3 on the f32 scores gives the bits of q scaled first."""
    q, k, v = _encoder_views(2, 2, 30, seed=4)
    mask = torch.arange(30)[None, :] >= torch.tensor([30, 11])[:, None]
    scaled = attention.flash_attention_reference(q, k, v, mask, scale=0.125)
    assert torch.equal(scaled, attention.flash_attention_reference(q * 0.125, k, v, mask))
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    assert torch.equal(attention.flash_attention_reference(qb, kb, vb, mask, scale=0.125),
                       attention.flash_attention_reference(qb * 0.125, kb, vb, mask))


def test_attention_strides_accepts_the_encoder_views():
    B, H, N = 2, 12, 37
    q, k, v = _encoder_views(B, H, N, torch.bfloat16)
    for name, t in (("q", q), ("k", k), ("v", v)):
        assert attention.attention_strides(t, name) == (N * 3 * H * 64, 64, 3 * H * 64)
    c = q.contiguous()
    assert attention.attention_strides(c, "q") == (H * N * 64, N * 64, 64)
    # a dimension of size 1 reports its contiguous stride, whatever it holds
    one = torch.empty(1000, dtype=torch.bfloat16).as_strided((1, 2, 3, 64), (5, 192, 64, 1))
    assert attention.attention_strides(one, "q") == (2 * 3 * 64, 3 * 64, 64)


@pytest.mark.parametrize("case, message", [
    ("last stride", "last stride 1"),
    ("stride of 68", "multiples of 8"),
    ("misaligned", "16-byte aligned"),
])
def test_attention_strides_rejects_what_tma_cannot_read(case, message):
    base = torch.zeros(2, 3, 16, 68, dtype=torch.bfloat16)
    bad = {
        "last stride": base[..., :64].transpose(2, 3).contiguous().transpose(2, 3),
        "stride of 68": base[..., :64],
        "misaligned": torch.zeros(2 * 3 * 16 * 64 + 1, dtype=torch.bfloat16)[1:].view(
            2, 3, 16, 64),
    }[case]
    with pytest.raises(ValueError, match=message):
        attention.attention_strides(bad, "q")


def test_rejects_unsupported_devices_and_shapes():
    q = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        attention.flash_attention(q, q, q)
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="B, H, N, D"):
        attention.flash_attention(x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N, lengths", [
    (150, [150, 70, 0]),  # ragged last tile, padded item, fully padded item
    (64, [64, 1, 33]),    # one tile exactly, a single valid key
    (7, [7, 7, 3]),       # shorter than a tile
    (257, None),          # no mask
])
def test_kernel_matches_plain_on_gpu(cuda_device, dtype, N, lengths):
    q, k, v, mask = _inputs(3, 2, N, lengths or [N] * 3, dtype, cuda_device, seed=N)
    mask = mask if lengths else None
    before = attention.flash_attention.launches
    out = attention.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out).all()
    ref = attention.flash_attention_reference(q, k, v, mask)
    rows = torch.tensor([n > 0 for n in (lengths or [N] * 3)], device=cuda_device)
    torch.testing.assert_close(out[rows].float(), ref[rows].float(), **TOL[dtype])
    if lengths and 0 in lengths:
        assert (out[~rows] == 0).all()  # every key padded: written as 0


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v, mask = _inputs(2, 2, 16, [16, 8], torch.bfloat16, cuda_device)
    bad = {
        "last stride 1": (q.transpose(2, 3).contiguous().transpose(2, 3), k, v, mask),
        "multiples of 8": (torch.zeros(2, 2, 16, 68, dtype=q.dtype, device=cuda_device)[..., :64],
                           k, v, mask),
        "head dim": tuple(t[..., :32].contiguous() for t in (q, k, v)) + (mask,),
        "bf16 or f32": (q.half(), k.half(), v.half(), mask),
        "does not match": (q, k.float(), v, mask),
        "padding_mask": (q, k, v, mask.int()),
        "scale > 0": (q, k, v, mask, -0.125),
    }
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)[1:].view(q.shape)
    bad["aligned"] = (shifted, k, v, mask)
    for message, args in bad.items():
        with pytest.raises((ValueError, TypeError), match=message):
            attention.flash_attention(*args)
    with pytest.raises(ValueError, match="padding_mask"):
        attention.flash_attention(q, k, v, mask.cpu())


def _check_against_plain(q, k, v, mask, scale, dtype):
    """One kernel call against the plain version: one launch, the output
    layout, valid items within TOL, all-padded items written as 0."""
    before = attention.flash_attention.launches
    out = attention.flash_attention(q, k, v, mask, scale=scale)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    assert torch.isfinite(out).all()
    ref = attention.flash_attention_reference(q, k, v, mask, scale)
    rows = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    if mask is not None:
        rows = (~mask).any(dim=1)
        assert (out[~rows] == 0).all()  # every key padded: written as 0
    torch.testing.assert_close(out[rows].float(), ref[rows].float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("N", [1, 7, 64, 199, 257, 1499])
def test_attention_kernel_on_encoder_views_matches_plain_on_gpu(cuda_device, dtype, masked, N):
    q, k, v = _encoder_views(3, 2, N, dtype, cuda_device, seed=N)
    mask = None
    if masked:
        lengths = torch.tensor([N, max(1, N // 2), 0] if N > 1 else [1, 1, 0])
        mask = (torch.arange(N)[None, :] >= lengths[:, None]).to(cuda_device)
    _check_against_plain(q, k, v, mask, 0.125, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [199, 400, 1499])
def test_attention_kernel_mask_with_gaps_on_gpu(cuda_device, N):
    """Padded keys in the middle, whole padded key tiles between valid
    ones, a lone valid key, an item with every key padded."""
    q, k, v = _encoder_views(5, 3, N, torch.bfloat16, cuda_device, seed=N)
    g = torch.Generator().manual_seed(N)
    mask = torch.rand(5, N, generator=g) < 0.3   # scattered padding
    mask[0, 64:192] = True                       # two padded tiles between valid ones
    mask[1] = True
    mask[1, N - 5] = False                       # one valid key, in the last tile
    mask[2, :] = True                            # every key padded
    mask[3, ::2] = True                          # every other key padded
    _check_against_plain(q, k, v, mask.to(cuda_device), 0.125, torch.bfloat16)


@pytest.mark.cuda
def test_attention_kernel_many_waves_on_gpu(cuda_device):
    """The fused step's shape, B * H = 768 (bh, q-block) pairs: several
    waves of blocks over the SMs."""
    q, k, v = _encoder_views(64, 12, 199, torch.bfloat16, cuda_device, seed=9)
    lengths = torch.randint(60, 200, (64,), generator=torch.Generator().manual_seed(9))
    mask = (torch.arange(199)[None, :] >= lengths[:, None]).to(cuda_device)
    _check_against_plain(q, k, v, mask, 0.125, torch.bfloat16)


@pytest.mark.cuda
def test_encoder_kernel_path_matches_plain_path_on_gpu(cuda_device):
    """A small encoder with head dim 64: kernel path vs plain path, f32."""
    kw = dict(embed_dim=128, depth=2, num_heads=2, prenet_depth=1,
              conv_feature_layers=((32, 10, 5), (32, 3, 2)), conv_pos_width=10,
              conv_pos_groups=4, conv_pos_depth=2, dtype="float32")
    g = torch.Generator().manual_seed(0)
    ref_model = Emotion2vecEncoder(EncoderConfig(**kw))
    state = {k: torch.randn(v.shape, generator=g) * 0.1 + (1.0 if "ln" in k or "norm" in k else 0.0)
             for k, v in ref_model.state_dict().items()}
    outs = []
    for flash in (True, False):
        with cuda_device:
            model = Emotion2vecEncoder(EncoderConfig(use_flash_attention=flash, **kw))
        model.load_state_dict(state)
        wav = torch.randn(3, 4000, generator=torch.Generator().manual_seed(1)).to(cuda_device)
        pad = torch.arange(4000)[None, :] >= torch.tensor([4000, 2500, 900])[:, None]
        with torch.no_grad():
            before = attention.flash_attention.launches
            feats, frame_mask = model(wav, pad.to(cuda_device))
            assert attention.flash_attention.launches - before == (3 if flash else 0)
        outs.append((feats, frame_mask))
    (a, mask), (b, _) = outs
    valid = ~mask
    torch.testing.assert_close(a[valid], b[valid], atol=1e-4, rtol=1e-4)


# fused LN, kernel vs plain: f32 by summation order and rsqrtf (2 ulp);
# bf16 by one bf16 rounding of outputs of magnitude up to ~4
LN_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
          torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
# conv + LN + GELU, kernel vs plain: both accumulate in f32 (the plain
# version's f32 matmuls without TF32), so f32 differs by summation order and
# bf16 by one rounding of the output
CONV_TOL = LN_TOL


def _ln_inputs(shape, dtype, device, seed=0, affine=True, residual=False):
    g = torch.Generator().manual_seed(seed)
    C = shape[-1]
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(device, dtype)
    res = torch.randn(*shape, generator=g).to(device, dtype) if residual else None
    scale = (torch.randn(C, generator=g) * 0.5 + 1).to(device) if affine else None
    bias = (torch.randn(C, generator=g) * 0.1).to(device) if affine else None
    return x, scale, bias, res


def _conv_inputs(B, L, c_in, c_out, k, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, L, c_in, generator=g).to(device, dtype)
    w = (torch.randn(k, c_in, c_out, generator=g) * (k * c_in) ** -0.5).to(device, dtype)
    scale = (torch.randn(c_out, generator=g) * 0.2 + 1).to(device)
    bias = (torch.randn(c_out, generator=g) * 0.1).to(device)
    return x, w, scale, bias


def test_cpu_norm_copy_and_conv_run_plain_versions_without_counting():
    x, scale, bias, res = _ln_inputs((3, 5, 256), torch.float32, "cpu", residual=True)
    counts = (fused_norm.fused_layernorm.launches, fused_norm.copy_rows.launches,
              conv.fused_conv_ln_gelu.launches)
    y = fused_norm.fused_layernorm(x, scale, bias, residual=res, activation="gelu_tanh")
    torch.testing.assert_close(y, fused_norm.fused_layernorm_reference(
        x, scale, bias, res, "gelu_tanh"))
    assert torch.equal(fused_norm.copy_rows(x), x)
    xc, w, sc, bi = _conv_inputs(2, 40, 4, 8, 3, torch.float32, "cpu")
    out = conv.fused_conv_ln_gelu(xc, w, sc, bi, 3, 2)
    assert out.shape == (2, 19, 8)
    torch.testing.assert_close(out, conv.fused_conv_ln_gelu_reference(xc, w, sc, bi, 3, 2))
    assert counts == (fused_norm.fused_layernorm.launches, fused_norm.copy_rows.launches,
                      conv.fused_conv_ln_gelu.launches)


def test_norm_probe_runs_its_cases_on_the_cpu_when_asked():
    """On the CPU the probe reports host time only, under its own name: no
    device metric (device ms, call ms, host µs per launch, GB/s)."""
    before = fused_norm.fused_layernorm.launches, fused_norm.copy_rows.launches
    rows = norm_probe.run_probe("cpu", iters=1,
                                shapes={"res_ln": (2, 3, 256), "ln_gelu": (2, 5, 128)})
    assert [r["name"] for r in rows] == ["res+LN kernel", "res+LN plain", "LN+GELU kernel",
                                         "LN+GELU plain", "copy kernel"]
    assert rows[0]["bytes"] == 3 * 2 * 3 * 256 * 2 and all(r["host_ms"] > 0 for r in rows)
    for r in rows:
        assert set(r) == {"name", "bytes", "device", "host_ms"} and r["device"] == "cpu"
    assert (fused_norm.fused_layernorm.launches, fused_norm.copy_rows.launches) == before


def test_norm_and_conv_wrappers_reject_what_they_do_not_take():
    x = torch.zeros(4, 128, device="meta")
    with pytest.raises(ValueError, match="no fused_norm kernel"):
        fused_norm.fused_layernorm(x)
    with pytest.raises(ValueError, match="no copy kernel"):
        fused_norm.copy_rows(x)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_norm.fused_layernorm(torch.zeros(4, 100))
    with pytest.raises(ValueError, match="together"):
        fused_norm.fused_layernorm(torch.zeros(4, 128), scale=torch.ones(128))
    with pytest.raises(ValueError, match="activation"):
        fused_norm.fused_layernorm(torch.zeros(4, 128), activation="relu")
    with pytest.raises(ValueError, match="no conv kernel"):
        conv.fused_conv_ln_gelu(torch.zeros(1, 8, 1, device="meta"),
                                torch.zeros(2, 1, 8, device="meta"),
                                torch.ones(8), torch.zeros(8), 2, 2)


def test_conv_reference_matches_conv1d_layer_norm_gelu():
    """The plain version against torch's own conv1d, layer_norm and exact
    GELU in float64: the polynomial erf is within 1.5e-7 of erf, so GELU
    is within |x| * 0.75e-7 of exact, < 1e-6 for these |x|."""
    x, w, scale, bias = _conv_inputs(2, 61, 3, 16, 4, torch.float64, "cpu")
    got = conv.fused_conv_ln_gelu_reference(x, w, scale, bias, 4, 3)
    y = torch.nn.functional.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=3)
    y = torch.nn.functional.layer_norm(y.transpose(1, 2), (16,), scale.double(),
                                       bias.double(), 1e-5)
    torch.testing.assert_close(got, torch.nn.functional.gelu(y), atol=1e-6, rtol=0)


@pytest.mark.parametrize("M", [1, 7, 8, 9, 12736, 12737, 204736])
def test_ln_plan_gives_every_row_to_one_warp(M):
    """The LN grid: warp w takes rows w, w + W, ... (as the kernel walks
    them); every row once, at most LN_ROWS_PER_WARP a warp, and no block
    without a row."""
    blocks = fused_norm.ln_plan(M)
    W = blocks * fused_norm.LN_WARPS
    taken = [list(range(w, M, W)) for w in range(W)]
    assert sorted(r for rows in taken for r in rows) == list(range(M))
    assert max(len(rows) for rows in taken) <= fused_norm.LN_ROWS_PER_WARP
    assert (blocks - 1) * fused_norm.LN_WARPS < M


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape, affine, residual, act", [
    ((3, 37, 768), True, True, None),            # the block norm shape, ragged rows
    ((9, 512), True, False, "gelu_tanh"),        # the conv LN + GELU variant
    ((5, 128), False, False, None),              # plain LN, one chunk per lane
    ((2, 3, 2048), True, True, "gelu_tanh"),     # the widest row the kernel takes
])
def test_fused_ln_kernel_matches_plain_on_gpu(cuda_device, dtype, shape, affine, residual, act):
    x, scale, bias, res = _ln_inputs(shape, dtype, cuda_device, affine=affine,
                                     residual=residual)
    before = fused_norm.fused_layernorm.launches
    out = fused_norm.fused_layernorm(x, scale, bias, residual=res, activation=act)
    torch.cuda.synchronize()
    assert fused_norm.fused_layernorm.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    ref = fused_norm.fused_layernorm_reference(x, scale, bias, res, act)
    torch.testing.assert_close(out.float(), ref.float(), **LN_TOL[dtype])


@pytest.mark.cuda
def test_fused_ln_backward_on_gpu_matches_cpu(cuda_device):
    x, scale, bias, res = _ln_inputs((4, 6, 256), torch.float32, "cpu", residual=True)
    g = torch.randn(4, 6, 256, generator=torch.Generator().manual_seed(1))
    grads = []
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in (x, res, scale, bias)]
        out = fused_norm.fused_layernorm(leaves[0], leaves[2], leaves[3], residual=leaves[1],
                                         activation="gelu_tanh")
        (out * g.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("numel, dtype", [(64 * 3199 * 512 // 64, torch.bfloat16),
                                          (1001, torch.bfloat16), (7, torch.float32)])
def test_copy_kernel_is_exact_on_gpu(cuda_device, numel, dtype):
    x = torch.randn(numel, generator=torch.Generator().manual_seed(2)).to(cuda_device, dtype)
    before = fused_norm.copy_rows.launches
    out = fused_norm.copy_rows(x)
    torch.cuda.synchronize()
    assert fused_norm.copy_rows.launches == before + 1
    assert torch.equal(out, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [128, 384, 768, 2048])  # 128, 384: 8-byte bf16 chunks
@pytest.mark.parametrize("M", [1, 7, 12737])  # fewer rows than warps; ragged
def test_fused_ln_grid_matches_plain_on_gpu(cuda_device, dtype, C, M):
    act = "gelu_tanh" if M == 7 else None
    x, scale, bias, res = _ln_inputs((M, C), dtype, cuda_device, seed=M + C, residual=True)
    before = fused_norm.fused_layernorm.launches
    out = fused_norm.fused_layernorm(x, scale, bias, residual=res, activation=act)
    torch.cuda.synchronize()
    assert fused_norm.fused_layernorm.launches == before + 1
    ref = fused_norm.fused_layernorm_reference(x, scale, bias, res, act)
    torch.testing.assert_close(out.float(), ref.float(), **LN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("nbytes, offset", [
    (5, 0),                          # fewer than 16 bytes: the tail alone
    (3 * 16384 + 16 * 5 + 7, 0),     # not a multiple of a block's 16 KB, with a tail
    (1 << 26, 0),                    # 4096 blocks, every one full
    (40000, 16),                     # an offset view, 16-byte aligned
])
def test_copy_kernel_edges_on_gpu(cuda_device, nbytes, offset):
    g = torch.Generator().manual_seed(nbytes)
    base = torch.randint(0, 256, (offset + nbytes,), generator=g, dtype=torch.uint8)
    x = base.to(cuda_device)[offset:]
    before = fused_norm.copy_rows.launches
    out = fused_norm.copy_rows(x)
    torch.cuda.synchronize()
    assert fused_norm.copy_rows.launches == before + 1
    assert torch.equal(out, x)


# (B, L, C_in, C_out, k, s, approx gelu), and the path conv_plan gives bf16
# (f32 always takes the FMA path)
CONV_CASES = [
    ((2, 4000, 1, 512, 10, 5, False), "row"),   # layer 0: C_in = 1
    ((2, 801, 512, 512, 3, 2, False), "tc"),    # layers 1-4, ragged tile
    ((3, 139, 512, 512, 2, 2, True), "tc"),     # layers 5-6, tanh GELU
    ((2, 97, 8, 8, 3, 2, False), "fma"),        # the JAX package's test shape
    ((1, 70, 64, 128, 3, 1, True), "tc"),       # stride 1, C_out 128
    ((2, 803, 512, 512, 3, 2, False), "tc"),    # (L - k) % s == 0: reads row L - 1
    ((2, 130, 512, 512, 2, 2, True), "tc"),     # T_out = 65: a last tile of 1 row
    ((1, 255, 512, 512, 3, 2, False), "tc"),    # T_out = 127: a last tile of 63 rows
    ((64, 399, 512, 512, 2, 2, False), "tc"),   # layer 6 at the step's B = 64
    ((2, 300, 128, 256, 3, 2, False), "tc"),    # C_out 256
    ((2, 301, 192, 384, 3, 3, True), "tc"),     # C_out 384, stride 3
    ((2, 264, 64, 128, 4, 4, False), "tc"),     # the largest stride the map takes
    ((2, 100, 32, 128, 3, 2, False), "fma"),    # C_in = 32: not a 64-channel step
    ((2, 90, 64, 128, 5, 5, False), "fma"),     # stride 5: past the map's box
    ((2, 4000, 1, 256, 10, 5, True), "row"),    # layer 0 at 256 channels
    ((3, 1003, 1, 512, 16, 7, False), "row"),   # 16 taps: a whole mma k-step
    ((2, 1000, 1, 512, 17, 5, False), "fma"),   # 17 taps: past the row path
]


@pytest.mark.parametrize("case, path", CONV_CASES)
def test_conv_plan_paths_of_the_test_shapes(case, path):
    B, L, c_in, c_out, k, s, _approx = case
    assert conv.conv_plan(B, L, c_in, c_out, k, s, torch.bfloat16).path == path
    assert conv.conv_plan(B, L, c_in, c_out, k, s, torch.float32).path == "fma"


E2V_LAYERS = ((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2


@pytest.mark.parametrize("B, samples, t_outs", [
    (64, 64000, (12799, 6399, 3199, 1599, 799, 399, 199)),      # the fused step, 4 s
    (16, 480000, (95999, 47999, 23999, 11999, 5999, 2999, 1499)),  # serving's 30 s bucket
])
def test_conv_plan_of_the_emotion2vec_front_end(B, samples, t_outs):
    """Layer 0 on the row path, layers 1-6 on the tensor-core path with a
    3-stage ring in 227,376 bytes and a block per SM walking the 64-row
    tiles (a block per tile where there are fewer tiles than SMs); f32 on
    the FMA path with the 32-row tile."""
    L, c_in = samples, 1
    for i, (c_out, k, s) in enumerate(E2V_LAYERS):
        plan = conv.conv_plan(B, L, c_in, c_out, k, s, torch.bfloat16)
        assert plan.t_out == t_outs[i] == conv.out_length(L, k, s)
        if i == 0:
            assert plan == conv.ConvPlan("row", t_outs[0], 16, 0, 0, 528)
        else:
            assert plan == conv.ConvPlan("tc", plan.t_out, 64, 3, 227376, 132)
            tiles = B * -(-plan.t_out // 64)
            assert conv.conv_plan(B, L, c_in, c_out, k, s, torch.bfloat16,
                                  sms=10**6).grid == tiles
        f32 = conv.conv_plan(B, L, c_in, c_out, k, s, torch.float32)
        assert f32.path == "fma" and f32.rows == 32 and f32.smem_bytes <= conv.MAX_SMEM
        L, c_in = plan.t_out, c_out


@pytest.mark.parametrize("c_out, stages, smem", [
    (128, 8, 199808), (256, 5, 208976), (384, 3, 177200), (512, 3, 227376)])
def test_conv_plan_ring_fits_shared_memory(c_out, stages, smem):
    """The most stages (at most 8) whose ring, affine pairs, LN exchange and
    barriers fit the 232,448 bytes a block may use, with 1024 to align."""
    plan = conv.conv_plan(2, 1000, 512, c_out, 3, 2, torch.bfloat16)
    assert (plan.stages, plan.smem_bytes) == (stages, smem)
    assert smem == conv.tc_smem_bytes(c_out, stages) <= conv.MAX_SMEM
    assert stages == conv.TC_MAX_STAGES or conv.tc_smem_bytes(c_out, stages + 1) > conv.MAX_SMEM
    assert conv.tc_stage_bytes(c_out) == 8192 * (1 + c_out // 64)


@pytest.mark.parametrize("L, k, s", [(803, 3, 2), (801, 3, 2), (130, 2, 2), (255, 3, 2),
                                     (12799, 3, 2), (264, 4, 4), (267, 4, 4), (70, 3, 1)])
def test_conv_plan_last_row_reads_inside_the_map(L, k, s):
    """The last valid output row's last tap reads input row (t_out - 1) s +
    k - 1 <= L - 1 (= L - 1 when (L - k) % s == 0), and every box of the
    last tile starts at a row of the x map (0 .. L - 1)."""
    plan = conv.conv_plan(1, L, 64, 128, k, s, torch.bfloat16)
    assert plan.path == "tc"
    last = (plan.t_out - 1) * s + k - 1
    assert last <= L - 1 and (last == L - 1) == ((L - k) % s == 0)
    t0 = (-(-plan.t_out // plan.rows) - 1) * plan.rows
    assert all(0 <= t0 * s + j <= L - 1 for j in range(k))


@pytest.mark.parametrize("c_in", [32, 64, 96, 512])
def test_every_shape_the_wmma_path_took_still_runs(c_in):
    """bf16, C_in % 32 == 0, C_out in {128, ..., 512}, any k >= s: the
    tensor-core path where C_in % 64 == 0 and s <= 4, else the FMA path;
    never a plan that raises."""
    for c_out in (128, 256, 384, 512):
        for s in (1, 2, 3, 4, 5):
            for k in (s, s + 1):
                plan = conv.conv_plan(2, 3 * k, c_in, c_out, k, s, torch.bfloat16)
                tc = c_in % 64 == 0 and s <= 4
                assert plan.path == ("tc" if tc else "fma")
                assert conv.uses_tensor_cores(torch.bfloat16, c_in, c_out, s) == tc
                assert plan.smem_bytes <= conv.MAX_SMEM


def test_conv_plan_raises_where_no_path_fits():
    with pytest.raises(ValueError, match="no conv kernel path"):
        conv.conv_plan(1, 4, 60000, 128, 1, 1, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B, L, c_in, c_out, k, s, approx", [case for case, _ in CONV_CASES])
def test_conv_kernel_matches_plain_on_gpu(cuda_device, dtype, B, L, c_in, c_out, k, s, approx):
    x, w, scale, bias = _conv_inputs(B, L, c_in, c_out, k, dtype, cuda_device, seed=L)
    before = conv.fused_conv_ln_gelu.launches
    out = conv.fused_conv_ln_gelu(x, w, scale, bias, k, s, approx_gelu=approx)
    torch.cuda.synchronize()
    assert conv.fused_conv_ln_gelu.launches == before + 1
    assert out.shape == (B, (L - k) // s + 1, c_out) and out.dtype == dtype
    assert torch.isfinite(out).all()
    ref = conv.fused_conv_ln_gelu_reference(x, w, scale, bias, k, s, approx)
    torch.testing.assert_close(out.float(), ref.float(), **CONV_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B, L, k, s", [(3, 801, 3, 2), (64, 399, 2, 2)])
def test_conv_persistent_grid_matches_tile_grid_on_gpu(cuda_device, B, L, k, s):
    """Blocks walking the tiles (the ring running on across tiles) give the
    bits of a block per tile."""
    x, w, scale, bias = _conv_inputs(B, L, 512, 512, k, torch.bfloat16, cuda_device, seed=B)
    plans = [conv.conv_plan(B, L, 512, 512, k, s, torch.bfloat16, sms=sms)
             for sms in (10**6, 8, 5)]
    assert plans[0].grid > 8 and (plans[1].grid, plans[2].grid) == (8, 5)
    outs = [conv.launch_plan(x, w, scale, bias, k, s, False, p) for p in plans]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
def test_norm_and_conv_kernels_reject_what_they_do_not_take(cuda_device):
    x, scale, bias, res = _ln_inputs((4, 256), torch.bfloat16, cuda_device, residual=True)
    with pytest.raises(TypeError, match="bf16 or f32"):
        fused_norm.fused_layernorm(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        fused_norm.fused_layernorm(torch.zeros(256, 4, device=cuda_device).T)
    with pytest.raises(ValueError, match="does not match"):
        fused_norm.fused_layernorm(x, scale, bias, residual=res.float())
    with pytest.raises(ValueError, match="at most"):
        fused_norm.fused_layernorm(torch.zeros(2, 4096, device=cuda_device))
    xc, w, sc, bi = _conv_inputs(1, 50, 32, 128, 3, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="does not match"):
        conv.fused_conv_ln_gelu(xc, w.float(), sc, bi, 3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        conv.fused_conv_ln_gelu(xc.transpose(1, 2).contiguous().transpose(1, 2), w, sc, bi, 3, 2)
    shifted = torch.empty(xc.numel() + 1, dtype=xc.dtype, device=cuda_device)[1:].view(xc.shape)
    with pytest.raises(ValueError, match="aligned"):
        conv.fused_conv_ln_gelu(shifted, w, sc, bi, 3, 2)
