"""PyTorch building blocks for the emotion2vec (data2vec-multi audio) encoder.

Counterparts of the JAX package's flax modules of the same names, with the
same parameter tree (flax ``kernel``/``scale`` become torch ``weight``), the
same (B, T, C) layout at every public function, and the same dtype casts:

- parameters are f32 and cast to the compute dtype at use, as flax's
  ``dtype=`` does;
- reference-path LayerNorms compute in f32 and return f32 (callers cast),
  like ``nn.LayerNorm(dtype=float32)``; ``FastLayerNorm`` keeps f32
  statistics with compute-dtype arithmetic.

flax's LayerNorm takes the variance as E[x^2] - E[x]^2, ``F.layer_norm`` as
E[(x - E[x])^2]; in f32 the two differ by rounding only (the parity tests'
f32 tolerance, atol 3e-5 / rtol 1e-4, covers it).

Convolutions go to ``F.conv1d``: in the JAX package they are XLA
convolutions, not Pallas kernels. Attention routes to the hand-written
kernel (``ops/attention.py``) when ``use_flash`` asks for it.

The training forward (d2v pretraining) has flax's dropout: keep with
probability 1 - rate, kept values scaled by 1 / (1 - rate). A block's keep
masks are drawn before it runs, in the order its forward uses them
(``AltBlock.draw_keeps``), so a block recomputed for its backward
(``torch.utils.checkpoint``) sees the same masks. Also here: the branches
the shipped config never takes (cosine attention, alibi, ``layer_norm_first``)
and the additive attention ``bias``.

Tensor parallelism (``tp_group``): ``AltAttention`` holds its rank's heads
and ``Mlp`` its share of the hidden width
(``parallel/mesh.py::shard_encoder_state`` gives the weights); the partial
outputs of the attention projection and of fc2 are summed over the group
with ``dist.all_reduce``, and their biases are added once, after the sum.
A differentiated forward (d2v pretraining) takes Megatron's two operators:
the replicated input of qkv and of fc1 is the identity forward and sums its
gradient over the group backward (``to_tp``), and the sum after proj and fc2
passes its gradient through unchanged (``row_parallel``). Every leaf
upstream of a block then gets its whole gradient on every rank, a sharded
leaf its shard's, and the replicated biases of proj and fc2 theirs once.
Under no gradient the sums are the plain collective, as in extraction. The
dropout keeps of a training forward are drawn at the full width of the
global batch on every rank, which takes its rows, its heads and its hidden
share (``AltBlock.draw_keeps``).
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention

# use_flash="auto" routes attention to the kernel at or beyond this frame
# count (the JAX package's crossover, kept for config compatibility).
FLASH_AUTO_MIN_FRAMES = 512


def _gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def big_neg(dtype: torch.dtype) -> float:
    return float(torch.finfo(dtype).min) / 2


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate (``keep``, or a
    draw from ``generator``), kept values scaled by 1 / (1 - rate)."""
    if rate <= 0:
        return x
    if rate >= 1:
        return torch.zeros_like(x)
    if keep is None:
        keep = draw_keep(x.shape, rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def draw_keep(shape, rate: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """A dropout keep mask: True with probability 1 - rate."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def _drop(x: torch.Tensor, rate: float, keeps: Optional[Iterator[torch.Tensor]]) -> torch.Tensor:
    """Dropout at one site of a block: the next of the block's keep masks
    (``keeps`` None: deterministic)."""
    if keeps is None or rate <= 0:
        return x
    return dropout(x, rate, keep=None if rate >= 1 else next(keeps))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=out_dtype)``: f32 statistics and
    arithmetic, result in ``out_dtype``."""

    def __init__(self, dim: int, eps: float, use_scale: bool = True,
                 use_bias: bool = True, out_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.ones(dim)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (self.dim,), self.weight, self.bias, self.eps)
        return y.to(self.out_dtype)


class FastLayerNorm(nn.Module):
    """LayerNorm with f32 statistics but compute-dtype normalize arithmetic
    (the JAX package's ``FastLayerNorm``, term for term)."""

    def __init__(self, dim: int, eps: float = 1e-6, use_scale: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = x.float()
        mu = z.mean(dim=-1, keepdim=True)
        var = (z * z).mean(dim=-1, keepdim=True) - mu * mu
        inv = torch.rsqrt(var + self.eps)
        y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
        if self.weight is not None:
            y = y * self.weight.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


def make_norm(
    fast: bool,
    eps: float,
    dim: int,
    use_scale: bool = True,
    use_bias: bool = True,
    stat_dtype: torch.dtype = torch.float32,
) -> nn.Module:
    """Reference-path LayerNorm (f32) or the FastLayerNorm variant."""
    if fast:
        return FastLayerNorm(dim, eps, use_scale=use_scale, use_bias=use_bias)
    return LayerNorm(dim, eps, use_scale=use_scale, use_bias=use_bias,
                     out_dtype=stat_dtype)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)``: f32 parameters, input and parameters
    cast to the compute dtype. weight is torch's (out, in)."""

    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


def tp_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def tp_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the group (each
    rank's partial products reach only its shard's share of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOverTP(torch.autograd.Function):
    """The partial sums reduced over the group forward; the (replicated)
    gradient passed to every rank's partial product backward."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.mark_dirty(y)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The replicated input of a column-parallel layer (qkv, fc1): itself,
    with its gradient summed over ``group`` in a differentiated forward."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTP.apply(x, group)


def row_parallel(dense: Dense, x: torch.Tensor, group) -> torch.Tensor:
    """``dense`` over a rank's slice of its input features, summed over the
    tensor-parallel ``group``; the bias is added once, after the sum. With
    no group this is ``dense(x)``. Under no gradient the sum is the plain
    collective; else an autograd op whose backward passes the gradient
    through."""
    if group is None:
        return dense(x)
    y = F.linear(x.to(dense.dtype), dense.weight.to(dense.dtype))
    if torch.is_grad_enabled() and y.requires_grad:
        y = _SumOverTP.apply(y, group)
    else:
        dist.all_reduce(y, group=group)
    return y if dense.bias is None else y + dense.bias.to(dense.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv`` over (B, T, C): weight is torch's (out, in/groups, k);
    the (B, C, T) transpose happens only around ``F.conv1d``."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv1d(x.to(self.dtype).transpose(1, 2), self.weight.to(self.dtype),
                     b, self.stride, self.padding, 1, self.groups)
        return y.transpose(1, 2)


class ConvFeatureExtractor(nn.Module):
    """wav2vec2-style conv stack: (B, T) waveform -> (B, T', C).

    ``fast_norm`` keeps the per-layer LayerNorm output in the compute dtype;
    otherwise it is f32 (fairseq's Fp32LayerNorm) and cast after the GELU.
    """

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]],
                 dtype: torch.dtype = torch.float32, fast_norm: bool = False,
                 gelu_approximate: bool = False, fast_ln: bool = False):
        super().__init__()
        self.n_layers = len(conv_layers)
        self.dtype = dtype
        self.gelu_approximate = gelu_approximate
        ln_dtype = dtype if fast_norm else torch.float32
        in_c = 1
        for i, (dim, kernel, stride) in enumerate(conv_layers):
            self.add_module(f"conv_{i}", Conv(in_c, dim, kernel, stride,
                                              bias=False, dtype=dtype))
            self.add_module(f"ln_{i}", make_norm(fast_ln, 1e-5, dim,
                                                 stat_dtype=ln_dtype))
            in_c = dim

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, :, None].to(self.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x)
            x = getattr(self, f"ln_{i}")(x)
            x = _gelu(x, self.gelu_approximate).to(self.dtype)
        return x


def conv_out_lengths(
    lengths: torch.Tensor, conv_layers: Sequence[Tuple[int, int, int]]
) -> torch.Tensor:
    """Output lengths through the conv stack: floor((L - k) / s + 1) per
    layer, as a float expression (clips shorter than the receptive field go
    to 0 or below, as in the JAX package)."""
    out = lengths
    for _dim, kernel, stride in conv_layers:
        out = torch.floor((out - kernel) / stride + 1).to(torch.int32)
    return out


def convert_padding_mask(
    padding_mask: torch.Tensor,  # (B, T) bool True=pad, at waveform rate
    out_t: int,
    conv_layers: Sequence[Tuple[int, int, int]],
) -> torch.Tensor:
    """Waveform-rate padding mask -> frame-rate mask."""
    in_lengths = torch.sum(~padding_mask, dim=-1)
    out_lengths = conv_out_lengths(in_lengths, conv_layers)
    frame_idx = torch.arange(out_t, device=padding_mask.device)[None, :]
    return frame_idx >= out_lengths[:, None]


class PositionalConv(nn.Module):
    """Depth-5 grouped-conv relative positional encoder.

    Padded frames are zeroed before every conv layer, so a padded batch
    reproduces per-clip (unpadded) extraction exactly."""

    def __init__(self, embed_dim: int, depth: int = 5, width: int = 95,
                 groups: int = 16, dtype: torch.dtype = torch.float32,
                 gelu_approximate: bool = False, fast_ln: bool = False):
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        self.gelu_approximate = gelu_approximate
        k = max(3, width // depth)
        # torch SamePad(k) trims the trailing element only for even k.
        self.trim = 1 if k % 2 == 0 else 0
        for i in range(depth):
            self.add_module(f"pos_conv_{i}", Conv(
                embed_dim, embed_dim, k, padding=k // 2, groups=groups,
                dtype=dtype))
            self.add_module(f"pos_ln_{i}", make_norm(
                fast_ln, 1e-5, embed_dim, use_scale=False, use_bias=False))

    def forward(self, x: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        keep = None
        if frame_mask is not None:
            keep = (~frame_mask).to(x.dtype)[..., None]
        for i in range(self.depth):
            if keep is not None:
                x = x * keep
            x = getattr(self, f"pos_conv_{i}")(x)
            if self.trim:
                x = x[:, : -self.trim]
            x = getattr(self, f"pos_ln_{i}")(x)
            x = _gelu(x, self.gelu_approximate).to(self.dtype)
        return x


class Mlp(nn.Module):
    """timm-style MLP: fc1 -> GELU -> drop -> fc2 -> drop."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int, drop: float = 0.0,
                 dtype: torch.dtype = torch.float32, gelu_approximate: bool = False,
                 tp_group=None):
        """``tp_group``: this rank holds ``hidden_dim / tp`` of the hidden
        units (fc1's rows, fc2's columns); fc2's partial sums are reduced."""
        super().__init__()
        self.drop = drop
        self.gelu_approximate = gelu_approximate
        self.tp_group = tp_group
        tp = tp_size(tp_group)
        if hidden_dim % tp:
            raise ValueError(f"MLP hidden width {hidden_dim} does not split over tp={tp}")
        self.hidden_dim = hidden_dim // tp
        self.fc1 = Dense(dim, self.hidden_dim, dtype)
        self.fc2 = Dense(self.hidden_dim, out_dim, dtype)

    def forward(self, x: torch.Tensor,
                keeps: Optional[Iterator[torch.Tensor]] = None) -> torch.Tensor:
        x = _drop(_gelu(self.fc1(to_tp(x, self.tp_group)), self.gelu_approximate), self.drop,
                  keeps)
        return _drop(row_parallel(self.fc2, x, self.tp_group), self.drop, keeps)


class AltAttention(nn.Module):
    """Multi-head self-attention with fused qkv. ``use_flash`` True, or
    "auto" at N >= FLASH_AUTO_MIN_FRAMES, routes the core to
    ``ops.attention.flash_attention`` when no bias, no cosine attention and
    no attention dropout is asked for (the JAX ``flash_ok``); otherwise the
    einsum path below. The kernel is forward-only: a differentiated block
    must not take it (``make_d2v_train_step`` refuses such a config).

    ``cosine_attention``: L2-normalised q and k with a learned per-head
    logit scale, clamped at log(1/0.01).

    ``tp_group``: this rank holds ``num_heads / tp`` heads (their q, k and v
    rows of qkv, their columns of proj, their logit scales); the projection's
    partial sums are reduced over the group."""

    def __init__(self, dim: int, num_heads: int, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, dtype: torch.dtype = torch.float32,
                 use_flash: Union[bool, str] = False,
                 fast_softmax: bool = False, cosine_attention: bool = False,
                 tp_group=None):
        super().__init__()
        tp = tp_size(tp_group)
        if num_heads % tp:
            raise ValueError(f"{num_heads} heads do not split over tp={tp}")
        self.num_heads = num_heads // tp  # this rank's heads
        self.head_dim = dim // num_heads
        self.tp_group = tp_group
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.dtype = dtype
        self.use_flash = use_flash
        self.fast_softmax = fast_softmax
        self.cosine_attention = cosine_attention
        width = self.num_heads * self.head_dim
        self.qkv = Dense(dim, width * 3, dtype)
        self.proj = Dense(width, dim, dtype)
        if cosine_attention:
            self.logit_scale = nn.Parameter(torch.full((self.num_heads, 1, 1),
                                                       math.log(10.0)))

    def flash_ok(self, n: int, bias: Optional[torch.Tensor], deterministic: bool) -> bool:
        want_flash = self.use_flash is True or (
            self.use_flash == "auto" and n >= FLASH_AUTO_MIN_FRAMES
        )
        return (want_flash and bias is None and not self.cosine_attention
                and (deterministic or self.attn_drop == 0.0))

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                keeps: Optional[Iterator[torch.Tensor]] = None) -> torch.Tensor:
        B, N, _ = x.shape
        H, head_dim = self.num_heads, self.head_dim
        C = H * head_dim
        scale = head_dim**-0.5

        qkv = self.qkv(to_tp(x, self.tp_group)).reshape(B, N, 3, H, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, N, H, Dh)

        if self.flash_ok(N, bias, keeps is None):
            # q, k, v go in as strided views of the projection output, and the
            # output comes back as a view of a (B, N, H, Dh) buffer: no copy on
            # either side. The kernel scales the f32 scores instead of q; at
            # Dh = 64 the scale is 2^-3, which gives the same bits.
            out = flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                padding_mask=padding_mask, scale=scale,
            ).transpose(1, 2)
        else:
            if self.cosine_attention:
                qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
                kn = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True), min=1e-12)
                attn = torch.einsum("bnhd,bmhd->bhnm", qn, kn)
                s = torch.exp(torch.clamp(self.logit_scale, max=math.log(1.0 / 0.01)))
                attn = attn * s.to(attn.dtype)[None]
            else:
                attn = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
            if bias is not None:
                attn = attn + bias
            if padding_mask is not None:
                attn = attn.masked_fill(
                    padding_mask[:, None, None, :], big_neg(attn.dtype)
                )
            if self.fast_softmax:
                m = attn.amax(dim=-1, keepdim=True)
                e = torch.exp((attn - m).float()).to(self.dtype)
                attn = e / e.sum(dim=-1, keepdim=True)
            else:
                attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
            attn = _drop(attn, self.attn_drop, keeps)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v)

        return _drop(row_parallel(self.proj, out.reshape(B, N, C), self.tp_group),
                     self.proj_drop, keeps)


class AltBlock(nn.Module):
    """Transformer block: post-LN (the shipped config), or the fairseq
    pre-LN branch with ``layer_norm_first`` (kept as the reference writes
    it: the MLP output replaces the residual).

    ``return_ffn_target``: also return the MLP output ``t`` before the
    post-MLP dropout and norm, the per-layer target the d2v teacher
    averages."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop: float = 0.0, attn_drop: float = 0.0, mlp_drop: float = 0.0,
                 post_mlp_drop: float = 0.0,
                 norm_eps: float = 1e-6, layer_norm_first: bool = False,
                 dtype: torch.dtype = torch.float32,
                 use_flash: Union[bool, str] = False,
                 gelu_approximate: bool = False, fast_ln: bool = False,
                 fast_softmax: bool = False, cosine_attention: bool = False,
                 return_ffn_target: bool = False, tp_group=None):
        super().__init__()
        self.dtype = dtype
        self.layer_norm_first = layer_norm_first
        self.post_mlp_drop = post_mlp_drop
        self.return_ffn_target = return_ffn_target
        self.attn = AltAttention(dim, num_heads, attn_drop, drop, dtype, use_flash,
                                 fast_softmax, cosine_attention, tp_group)
        self.norm1 = make_norm(fast_ln, norm_eps, dim)
        self.norm2 = make_norm(fast_ln, norm_eps, dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, mlp_drop, dtype, gelu_approximate,
                       tp_group)
        self.hidden_dim = self.mlp.hidden_dim

    def draw_keeps(self, x: torch.Tensor, generator: Optional[torch.Generator],
                   bias: Optional[torch.Tensor] = None,
                   rows: Optional[Tuple[int, slice]] = None) -> List[torch.Tensor]:
        """The block's dropout keep masks for input ``x``, in the order its
        forward uses them (attention probabilities, attention output, the
        MLP's two sites, post-MLP); a site with rate 0 or 1 takes none.

        Each mask is drawn at the full width (every head, the whole hidden
        width) and, with ``rows`` = (the global batch's rows, this rank's
        slice of them), for the global batch, as one process draws it; the
        block keeps its rows, and under tp its heads of the attention
        probabilities and its hidden share (the order of
        ``parallel/mesh.py::shard_encoder_state``). The C-wide sites are the
        same on every tp rank."""
        B, N, C = x.shape
        total, mine = rows if rows is not None else (B, slice(None))
        attn = self.attn
        tp, r = tp_size(attn.tp_group), tp_rank(attn.tp_group)
        heads = slice(r * attn.num_heads, (r + 1) * attn.num_heads)
        hidden = slice(r * self.hidden_dim, (r + 1) * self.hidden_dim)
        whole = slice(None)
        sites = []
        if not attn.flash_ok(N, bias, False):
            sites.append(((total, attn.num_heads * tp, N, N), attn.attn_drop, (mine, heads)))
        sites += [((total, N, C), attn.proj_drop, (mine,)),
                  ((total, N, self.hidden_dim * tp), self.mlp.drop, (mine, whole, hidden)),
                  ((total, N, C), self.mlp.drop, (mine,)),
                  ((total, N, C), self.post_mlp_drop, (mine,))]
        return [draw_keep(shape, rate, generator, x.device)[cut]
                for shape, rate, cut in sites if 0 < rate < 1]

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                keeps: Optional[Sequence[torch.Tensor]] = None):
        """``keeps``: the masks of ``draw_keeps`` for a training forward;
        None runs deterministic."""
        it = None if keeps is None else iter(keeps)
        if self.layer_norm_first:
            x = x + self.attn(self.norm1(x).to(self.dtype), padding_mask, bias, it)
            t = self.mlp(self.norm2(x).to(self.dtype), it)
            x = t + _drop(t, self.post_mlp_drop, it)
        else:
            x = x + self.attn(x, padding_mask, bias, it)
            r = self.norm1(x).to(self.dtype)
            t = self.mlp(r, it)
            x = self.norm2(r + _drop(t, self.post_mlp_drop, it)).to(self.dtype)
        if self.return_ffn_target:
            return x, t
        return x


# ---------------------------------------------------------------------------
# alibi positional bias (reference base.py:538-642), for
# EncoderConfig.use_alibi_encoder
# ---------------------------------------------------------------------------
def alibi_slopes(attention_heads: int) -> np.ndarray:
    """Per-head geometric slopes, with the reference's interleave for a head
    count that is not a power of 2."""

    def power_of_2(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * start**i for i in range(n)]

    if math.log2(attention_heads).is_integer():
        return np.array(power_of_2(attention_heads))
    closest = 2 ** math.floor(math.log2(attention_heads))
    extra = alibi_slopes(2 * closest)[0::2][: attention_heads - closest]
    return np.concatenate([power_of_2(closest), extra])


def alibi_bias(time_steps: int, attention_heads: int, scale: float = 1.0,
               dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """(1, H, T, T) symmetric distance bias slope_h * -|i - j|, 0 on the
    diagonal, broadcast over the batch."""
    pos = np.arange(time_steps)
    dist = -np.abs(pos[None, :] - pos[:, None]).astype(np.float64)
    bias = alibi_slopes(attention_heads)[:, None, None] * dist[None]
    return (scale * torch.as_tensor(bias, dtype=dtype, device=device))[None]
