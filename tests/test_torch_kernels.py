"""The port's attention wrapper on its own: input checks and the plain
version on the CPU, and (``cuda`` marker) the Hopper kernel against its
plain version on the card.

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
        "contiguous": (q.transpose(2, 3).contiguous().transpose(2, 3), k, v, mask),
        "head dim": tuple(t[..., :32].contiguous() for t in (q, k, v)) + (mask,),
        "bf16 or f32": (q.half(), k.half(), v.half(), mask),
        "does not match": (q, k.float(), v, mask),
        "padding_mask": (q, k, v, mask.int()),
    }
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)[1:].view(q.shape)
    bad["aligned"] = (shifted, k, v, mask)
    for message, args in bad.items():
        with pytest.raises((ValueError, TypeError), match=message):
            attention.flash_attention(*args)
    with pytest.raises(ValueError, match="padding_mask"):
        attention.flash_attention(q, k, v, mask.cpu())


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
