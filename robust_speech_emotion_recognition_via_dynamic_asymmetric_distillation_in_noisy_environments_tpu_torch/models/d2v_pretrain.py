"""data2vec-2.0 self-supervised pretraining of the emotion2vec encoder.

Counterpart of the JAX package's module of the same name, function for
function:

- the student sees only the kept tokens of ``clone_batch`` different masks
  of each clip (``models/d2v_masking.py``), the teacher the whole clip once;
- the teacher is the same model with the EMA copies of its blocks swapped in
  (``ema_encoder_only``: the main blocks; else every encoder submodule), run
  under ``torch.no_grad()`` on the student's detached local features;
- targets: the average of the top-K blocks' FFN outputs, instance-normed
  per layer; frame loss (1/sqrt(D)-scaled L2 or smooth-L1 at masked frames)
  plus the utterance loss (valid-frame means);
- ``Decoder1d``: grouped convs with residuals, fed by mask-token
  restoration;
- AdamW with global-norm clipping and optax's warmup-cosine schedule, as a
  functional optimizer that rounds as optax does; the EMA in f32 whatever
  its storage dtype. On the card both run as one multi-tensor kernel pass
  (``optimizer_and_ema``, ``ops/d2v_update.py``) that repeats the per-leaf
  code's arithmetic.

State is plain dicts of tensors keyed as ``D2vPretrainModel.state_dict()``
(``torch.func.functional_call`` runs the model on them). The student's
encoder keys are ``Emotion2vecEncoder``'s, so ``encoder_params`` loads into
the extraction encoder.

Random draws (masks, mask-token noise, dropout) come from an explicit
``torch.Generator``, or ready-made through ``D2vDraws`` (the tests feed
the JAX draws there). The attention kernel is forward-only:
``make_d2v_train_step`` refuses a config that would send a differentiated
block through it.

Over a (dp, tp) process grid (``parallel/d2v_sharded.py``) the loss takes a
``BatchCut``: the rank runs its rows of the global batch, draws every
random number of the global batch in the single-process order and keeps
its rows, divides its partial sums by the global batch's denominators and
takes the collapse statistics over the global batch, so that the dp sum of
the ranks' gradients is the global batch's gradient and every rank reads
the same metrics.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..configs import D2vPretrainConfig, EncoderConfig
from ..ops.d2v_update import Hyper, fused_update
from ..utils import profiling
from .d2v_masking import (
    apply_mask,
    gather_unmasked,
    gather_unmasked_mask,
    make_mask_info,
    restore_with_mask_tokens,
    sample_random_mask,
    sample_span_mask,
    span_mask_uniforms,
)
from .emotion2vec import make_block, run_block, torch_dtype
from .layers import (
    FLASH_AUTO_MIN_FRAMES,
    Conv,
    ConvFeatureExtractor,
    Dense,
    PositionalConv,
    convert_padding_mask,
    draw_keep,
    dropout,
    make_norm,
)

Params = Dict[str, torch.Tensor]


class Decoder1d(nn.Module):
    """Grouped-conv d2v decoder: per layer Conv1d(groups) + SamePad +
    channel LN (no affine) + GELU, a residual add where the channel counts
    match, then the projection head back to ``input_dim``."""

    def __init__(self, dcfg, input_dim: int, dtype: torch.dtype = torch.float32,
                 fast_ln: bool = False):
        super().__init__()
        self.dcfg = dcfg
        self.dtype = dtype
        k = dcfg.decoder_kernel
        self.trim = 1 if k % 2 == 0 else 0  # torch SamePad
        in_c = input_dim
        for i in range(dcfg.decoder_layers):
            self.add_module(f"conv_{i}", Conv(in_c, dcfg.decoder_dim, k, padding=k // 2,
                                              groups=dcfg.decoder_groups, dtype=dtype))
            self.add_module(f"ln_{i}", make_norm(fast_ln, 1e-5, dcfg.decoder_dim,
                                                 use_scale=False, use_bias=False))
            in_c = dcfg.decoder_dim
        curr = dcfg.decoder_dim
        for i in range(dcfg.projection_layers - 1):
            nxt = int(curr * dcfg.projection_ratio) if i == 0 else curr
            self.add_module(f"proj_{i}", Dense(curr, nxt, dtype))
            curr = nxt
        self.proj_out = Dense(curr, input_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dc = self.dcfg
        residual = x
        for i in range(dc.decoder_layers):
            x = getattr(self, f"conv_{i}")(x)
            if self.trim:
                x = x[:, : -self.trim]
            x = F.gelu(getattr(self, f"ln_{i}")(x)).to(self.dtype)
            if dc.decoder_residual and residual.shape[-1] == x.shape[-1]:
                x = x + residual
            residual = x
        for i in range(dc.projection_layers - 1):
            x = F.gelu(getattr(self, f"proj_{i}")(x)).to(self.dtype)
        return self.proj_out(x)


class D2vPretrainModel(nn.Module):
    """Student encoder + decoder, under ``Emotion2vecEncoder``'s submodule
    names. ``forward(*args, method=...)`` dispatches to ``local_features``,
    ``positional``, ``contextualize`` or ``decode``, so that
    ``functional_call`` can run any of them on a params dict. ``tp_group``:
    the blocks of one tensor-parallel rank (its heads and MLP share); the
    rest is replicated."""

    def __init__(self, cfg: EncoderConfig, pcfg: D2vPretrainConfig, tp_group=None):
        super().__init__()
        self.tp_group = tp_group
        self.cfg, self.pcfg = cfg, pcfg
        dtype = torch_dtype(cfg.dtype)
        self.dtype = dtype
        feat_dim = cfg.conv_feature_layers[-1][0]
        self.local_encoder = ConvFeatureExtractor(
            cfg.conv_feature_layers, dtype=dtype, fast_norm=cfg.fast_conv_norm,
            gelu_approximate=cfg.gelu_approximate, fast_ln=cfg.fast_ln)
        self.proj_ln = make_norm(cfg.fast_ln, 1e-5, feat_dim)
        self.proj = Dense(feat_dim, cfg.embed_dim, dtype)
        self.pos_conv = PositionalConv(
            cfg.embed_dim, depth=cfg.conv_pos_depth, width=cfg.conv_pos_width,
            groups=cfg.conv_pos_groups, dtype=dtype,
            gelu_approximate=cfg.gelu_approximate, fast_ln=cfg.fast_ln)
        self.prenet_ln = make_norm(cfg.fast_ln, cfg.norm_eps, cfg.embed_dim)
        names = [f"prenet_block_{i}" for i in range(cfg.prenet_depth)]
        names += [f"block_{i}" for i in range(cfg.depth)]
        for name in names:
            self.add_module(name, make_block(cfg, return_ffn_target=True, tp_group=tp_group))
        self.block_names = tuple(names)
        self.decoder = Decoder1d(pcfg.decoder, cfg.embed_dim, dtype, cfg.fast_ln)

    def local_features(self, wav: torch.Tensor, padding_mask: Optional[torch.Tensor] = None):
        """wav -> projected local features and the frame-rate padding mask."""
        x = self.local_encoder(wav)
        x = self.proj(self.proj_ln(x).to(self.dtype))
        frame_mask = None
        if padding_mask is not None:
            frame_mask = convert_padding_mask(padding_mask, x.shape[1],
                                              self.cfg.conv_feature_layers)
        return x, frame_mask

    def positional(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor] = None):
        return self.pos_conv(x, frame_mask)

    def contextualize(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor] = None,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None,
                      rows: Optional[Tuple[int, slice]] = None):
        """prenet LN + prenet blocks + main blocks -> (x, the main blocks'
        FFN targets). With ``pcfg.remat_blocks`` a differentiated block is
        recomputed in the backward (its dropout masks drawn before it).
        ``rows``: this rank's cut of the global batch's dropout draws
        (``AltBlock.draw_keeps``)."""
        remat = self.pcfg.remat_blocks and torch.is_grad_enabled()
        x = self.prenet_ln(x).to(self.dtype)
        targets = []
        for name in self.block_names:
            x, t = run_block(getattr(self, name), x, frame_mask, None, deterministic,
                             generator, remat=remat, rows=rows)
            if not name.startswith("prenet"):
                targets.append(t)
        return x, targets

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(x)

    def forward(self, *args, method: str = "full", **kw):
        if method != "full":
            return getattr(self, method)(*args, **kw)
        wav, padding_mask = args[0], (args[1] if len(args) > 1 else None)
        x, fm = self.local_features(wav, padding_mask)
        x = x + self.positional(x, fm)
        x, _ = self.contextualize(x, fm, **kw)
        return x, self.decode(x)


def _apply(model: D2vPretrainModel, params: Params, method: str, *args, **kw):
    return functional_call(model, params, args, dict(kw, method=method))


# ---------------------------------------------------------------------------
# initialisation (flax's defaults: lecun-normal kernels, zero biases)
# ---------------------------------------------------------------------------
def _lecun_normal(shape, fan_in: int, generator, device) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at +-2 std, scaled to
    variance 1 / fan_in."""
    lo, hi = 0.5 * math.erfc(2.0 / math.sqrt(2.0)), 0.5 * math.erfc(-2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return (z * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)).float()


def init_params(model: nn.Module, generator: Optional[torch.Generator] = None) -> Params:
    """A fresh params dict for ``model``: Dense and Conv weights
    lecun-normal, biases zero, LayerNorm scales one, the cosine attention's
    logit scale log(10)."""
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for name, mod in model.named_modules():
        if isinstance(mod, (Dense, Conv)):
            w = params[f"{name}.weight"]
            fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
            params[f"{name}.weight"] = _lecun_normal(w.shape, fan_in, generator, w.device)
    return params


# ---------------------------------------------------------------------------
# targets / losses
# ---------------------------------------------------------------------------
def _instance_norm_time(t: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over the time axis per (batch, channel)."""
    mu = t.mean(dim=1, keepdim=True)
    var = t.var(dim=1, keepdim=True, unbiased=False)
    return (t - mu) / torch.sqrt(var + eps)


def _layer_norm_lastdim(t: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = t.mean(dim=-1, keepdim=True)
    var = t.var(dim=-1, keepdim=True, unbiased=False)
    return (t - mu) / torch.sqrt(var + eps)


def make_targets(layer_targets: Sequence[torch.Tensor], pcfg: D2vPretrainConfig) -> torch.Tensor:
    """The top-K layers' FFN outputs in f32, averaged, with the configured
    normalisations."""
    tl = [t.float() for t in layer_targets[-pcfg.average_top_k_layers:]]
    if pcfg.instance_norm_target_layer:
        tl = [_instance_norm_time(t) for t in tl]
    if pcfg.layer_norm_target_layer:
        tl = [_layer_norm_lastdim(t) for t in tl]
    y = sum(tl) / len(tl)
    if pcfg.layer_norm_targets:
        y = _layer_norm_lastdim(y)
    if pcfg.instance_norm_targets:
        y = _instance_norm_time(y)
    return y


def dp_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (a copy, without a
    gradient); ``x`` itself with no group."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def d2v_loss(pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor, beta: float,
             scale: Optional[float], group=None) -> torch.Tensor:
    """1/sqrt(D)-scaled L2 (beta 0) or smooth-L1 regression in f32,
    averaged over the weighted positions; with a dp ``group``, this rank's
    part of the average over every rank's positions."""
    d = pred.float() - target.float()
    if beta == 0:
        loss = d * d
    else:
        a = torch.abs(d)
        loss = torch.where(a < beta, 0.5 * d * d / beta, a - 0.5 * beta)
    if scale is None:
        scale = 1.0 / math.sqrt(pred.shape[-1])
    per_pos = loss.sum(dim=-1) * scale
    w = weight.float()
    return (per_pos * w).sum() / torch.clamp(dp_sum(w.sum(), group), min=1.0)


def compute_var(y: torch.Tensor, valid: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
    """sqrt(per-dim unbiased variance across tokens + 1e-6), averaged over
    dims: the collapse guards' statistic, over ``valid`` tokens only when
    given. With a dp ``group`` (and ``valid``), over every rank's tokens:
    the global mean first, then the global sum of squares about it."""
    z = y.reshape(-1, y.shape[-1]).float()
    if valid is None:
        n = float(max(z.shape[0], 1))
        mu = z.mean(dim=0)
        var = ((z - mu) ** 2).sum(dim=0) / max(n - 1.0, 1.0)
    else:
        w = valid.reshape(-1, 1).float()
        n = torch.clamp(dp_sum(w.sum(), group), min=1.0)
        mu = dp_sum((z * w).sum(dim=0), group) / n
        var = dp_sum((w * (z - mu) ** 2).sum(dim=0), group) / torch.clamp(n - 1.0, min=1.0)
    return torch.sqrt(var + 1e-6).mean()


def annealed_decay(pcfg: D2vPretrainConfig, step: torch.Tensor) -> torch.Tensor:
    """The EMA decay at ``step``: linear from ema_decay to ema_end_decay
    over ema_anneal_end_step steps."""
    start, end = pcfg.ema_decay, pcfg.ema_end_decay
    total = max(pcfg.ema_anneal_end_step, 1)
    frac = torch.clamp(step.float() / total, 0.0, 1.0)
    return end - (end - start) * (1.0 - frac)


# ---------------------------------------------------------------------------
# state, EMA and the optimizer
# ---------------------------------------------------------------------------
class D2vAdamState(NamedTuple):
    count: torch.Tensor  # () int32
    mu: Params  # stored in adam_mu_dtype
    nu: Params


class D2vTrainState(NamedTuple):
    params: Params  # the student, D2vPretrainModel's state_dict keys
    ema_blocks: Params  # the teacher's EMA copies, in pcfg.ema_dtype
    opt_state: D2vAdamState
    step: torch.Tensor  # () int32


def _ema_prefixes(cfg: EncoderConfig, pcfg: D2vPretrainConfig, params: Params) -> set:
    if pcfg.ema_encoder_only:
        return {f"block_{i}" for i in range(cfg.depth)}
    return {k.split(".")[0] for k in params} - {"decoder"}


def init_ema_blocks(params: Params, cfg: EncoderConfig, pcfg: D2vPretrainConfig) -> Params:
    """Copies of the teacher-owned params in ``pcfg.ema_dtype``."""
    keep = _ema_prefixes(cfg, pcfg, params)
    dt = torch_dtype(pcfg.ema_dtype)
    return {k: v.detach().to(dt, copy=True) for k, v in params.items()
            if k.split(".")[0] in keep}


def merge_teacher_params(params: Params, ema_blocks: Params) -> Params:
    """The student's params with the EMA copies swapped in, cast to the
    student's dtype."""
    return {**params, **{k: e.to(params[k].dtype) for k, e in ema_blocks.items()}}


def encoder_params(params: Params) -> Params:
    """The params without the decoder: ``Emotion2vecEncoder``'s keys."""
    return {k: v for k, v in params.items() if not k.startswith("decoder.")}


class D2vOptimizer:
    """optax's ``chain(clip_by_global_norm, adamw(warmup_cosine_decay))`` as
    functions of (grads, state, params), rounding as optax does: the learning
    rate at the pre-increment count, the bias corrections at the
    incremented one, decoupled weight decay on every leaf, the first moment
    stored in ``adam_mu_dtype`` after the update used it unrounded, its
    decay product taken in that dtype."""

    eps = 1e-8

    def __init__(self, pcfg: D2vPretrainConfig):
        self.peak = pcfg.learning_rate
        self.b1, self.b2 = pcfg.adam_betas
        self.weight_decay = pcfg.weight_decay
        self.max_norm = pcfg.grad_clip
        # optax needs decay_steps > warmup: clamp warmup for runs shorter
        # than the configured warmup
        self.warmup = min(pcfg.warmup_steps, max(pcfg.max_steps - 1, 0))
        self.decay_steps = max(pcfg.max_steps, self.warmup + 1)
        self.mu_dtype = torch_dtype(pcfg.adam_mu_dtype) if pcfg.adam_mu_dtype else None

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps)."""
        c = count.float()
        span = float(self.decay_steps - self.warmup)
        k = torch.clamp(c - self.warmup, max=span)
        lr = self.peak * (0.5 * (1 + torch.cos(math.pi * k / span)))
        if self.warmup > 0:
            frac = 1 - torch.clamp(c, 0, self.warmup) / self.warmup
            lr = torch.where(c < self.warmup, (0.0 - self.peak) * frac + self.peak, lr)
        return lr

    def schedule(self, count: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The step's scalars from the pre-increment count: (count + 1, c1,
        c2, -lr), the bias corrections at the incremented count and the
        learning rate at the pre-increment one."""
        n = count + 1
        return n, 1 - self.b1 ** n.float(), 1 - self.b2 ** n.float(), -self.learning_rate(count)

    def init(self, params: Params) -> D2vAdamState:
        device = next(iter(params.values())).device
        return D2vAdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(v, dtype=self.mu_dtype) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
        )

    def update(self, grads: Params, state: D2vAdamState, params: Params,
               norm: Optional[torch.Tensor] = None) -> Tuple[Params, D2vAdamState]:
        """``norm``: the gradient's global norm where ``grads`` is a shard
        of it (``parallel/d2v_sharded.py``), else taken over ``grads``."""
        if norm is None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < self.max_norm
        grads = {k: torch.where(keep, g, (g / norm) * self.max_norm) for k, g in grads.items()}
        b1, b2 = self.b1, self.b2
        mu = {}
        for k, g in grads.items():
            # b1 * mu in mu's storage dtype, b1 rounded to it: optax's weakly
            # typed scalar takes a bf16 moment's dtype (0.9 -> 0.8984375)
            m = state.mu[k]
            mu[k] = (1 - b1) * g + torch.tensor(b1, dtype=m.dtype, device=m.device) * m
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k] for k, g in grads.items()}
        count, c1, c2, step = self.schedule(state.count)
        updates = {k: step * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
                              + self.weight_decay * params[k]) for k in grads}
        if self.mu_dtype is not None:
            mu = {k: v.to(self.mu_dtype) for k, v in mu.items()}
        return updates, D2vAdamState(count, mu, nu)


def build_d2v_optimizer(pcfg: D2vPretrainConfig) -> D2vOptimizer:
    return D2vOptimizer(pcfg)


def optimizer_and_ema_per_leaf(tx: D2vOptimizer, pcfg: D2vPretrainConfig, state: D2vTrainState,
                               params: Params, grads: Dict[str, Optional[torch.Tensor]],
                               norm: Optional[torch.Tensor] = None
                               ) -> Tuple[D2vTrainState, torch.Tensor]:
    """``optimizer_and_ema`` leaf by leaf on any device: the plain version
    that the CPU runs and the card tests hold the kernel to."""
    grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
    updates, opt_state = tx.update(grads, state.opt_state, params, norm)
    params = {k: p + updates[k] for k, p in params.items()}
    decay = annealed_decay(pcfg, state.step)
    # EMA arithmetic in f32 whatever the storage dtype
    ema = {k: (decay * e.float() + (1.0 - decay) * params[k].float()).to(e.dtype)
           for k, e in state.ema_blocks.items()}
    return D2vTrainState(params, ema, opt_state, state.step + 1), decay


def optimizer_and_ema(tx: D2vOptimizer, pcfg: D2vPretrainConfig, state: D2vTrainState,
                      params: Params, grads: Dict[str, Optional[torch.Tensor]],
                      norm: Optional[torch.Tensor] = None) -> Tuple[D2vTrainState, torch.Tensor]:
    """The optimizer step and the EMA update of ``state`` from the
    gradients at ``params`` (its detached leaves; None for a leaf without a
    gradient, read as zeros) -> (the next state, the EMA decay used). For
    CUDA tensors one multi-tensor kernel pass (``ops/d2v_update.py``) over
    the scalars the per-leaf code computes, with no host-device sync; for
    CPU tensors ``optimizer_and_ema_per_leaf``. ``norm``: as
    ``D2vOptimizer.update``'s. ``state`` is not written."""
    if not next(iter(params.values())).is_cuda:
        return optimizer_and_ema_per_leaf(tx, pcfg, state, params, grads, norm)
    count, c1, c2, neg_lr = tx.schedule(state.opt_state.count)
    decay = annealed_decay(pcfg, state.step)
    p, mu, nu, ema = fused_update(
        params, grads, state.opt_state.mu, state.opt_state.nu, state.ema_blocks,
        Hyper(tx.b1, tx.b2, tx.eps, tx.weight_decay, tx.max_norm), tx.mu_dtype or torch.float32,
        neg_lr, c1, c2, decay, norm)
    return D2vTrainState(p, ema, D2vAdamState(count, mu, nu), state.step + 1), decay


def init_d2v_state(cfg: EncoderConfig, pcfg: D2vPretrainConfig,
                   generator: Optional[torch.Generator] = None, device=None
                   ) -> Tuple[D2vPretrainModel, D2vOptimizer, D2vTrainState]:
    """The model (its own tensors on the meta device: every call passes a
    params dict), the optimizer and a freshly initialised state."""
    with torch.device(device or "cpu"):
        model = D2vPretrainModel(cfg, pcfg)
    params = init_params(model, generator)
    model.to("meta")
    tx = build_d2v_optimizer(pcfg)
    state = D2vTrainState(
        params=params,
        ema_blocks=init_ema_blocks(params, cfg, pcfg),
        opt_state=tx.init(params),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )
    return model, tx, state


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
class D2vDraws(NamedTuple):
    """A step's random numbers given ready-made (the tests feed the JAX
    draws here); a field left None is drawn from the step's generator.
    Rows are B * clone_batch; T is the crop's frame count, D the width.
    The encoder blocks' dropout always draws from the generator (the
    tests that hold the port to JAX run with it off)."""

    mask: Optional[Tuple[torch.Tensor, ...]] = None  # span: (starts, fill) uniforms; random: (u,)
    tok: Optional[torch.Tensor] = None  # (rows, T, D) normal: masked inputs' noise
    din: Optional[torch.Tensor] = None  # (rows, len_keep, D) bool: decoder-input dropout keep
    dtok: Optional[torch.Tensor] = None  # (rows, T - len_keep, D) normal: mask tokens
    chan: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # channel span uniforms


class BatchCut(NamedTuple):
    """A rank's cut of the global batch on the process grid: its clips
    ``rows`` of the global ``batch`` and the dp ``group`` over which the
    loss statistics are summed."""

    rows: slice
    batch: int
    group: Any


def _cut_rows(x, rows: slice):
    """Rows ``rows`` of a tensor or of each tensor of a tuple."""
    if isinstance(x, tuple):
        return tuple(t[rows] for t in x)
    return x[rows]


def conv_frames(n_samples: int, conv_layers) -> int:
    """Frames out of the conv front end for ``n_samples`` samples."""
    for _dim, kernel, stride in conv_layers:
        n_samples = (n_samples - kernel) // stride + 1
    return n_samples


def make_d2v_loss_fn(model: D2vPretrainModel, train: bool = True):
    """The d2v objective as a function of (params, ema_blocks, wav, wav_pad,
    generator=None, draws=None, cut=None) -> (total, metrics).
    ``train=False`` turns the dropouts off (validation); the masks still
    draw. ``cut`` (a ``BatchCut``): ``wav``/``wav_pad`` are this rank's rows
    of the global batch, ``draws`` the global batch's, and the metrics the
    global batch's; ``total`` is this rank's part of the global loss."""
    pcfg = model.pcfg

    def loss_fn(params: Params, ema_blocks: Params, wav: torch.Tensor, wav_pad: torch.Tensor,
                generator: Optional[torch.Generator] = None, draws: Optional[D2vDraws] = None,
                cut: Optional[BatchCut] = None):
        draws = draws or D2vDraws()
        group = None if cut is None else cut.group
        x_local, frame_mask = _apply(model, params, "local_features", wav, wav_pad)
        b, t, d = x_local.shape
        dev = x_local.device
        fm = frame_mask if frame_mask is not None else torch.zeros((b, t), dtype=torch.bool,
                                                                    device=dev)

        # teacher: unmasked pass with the EMA'd blocks, no graph
        with torch.no_grad():
            t_params = merge_teacher_params({k: v.detach() for k, v in params.items()},
                                            ema_blocks)
            if pcfg.ema_encoder_only:
                xt_local = x_local.detach()  # the student's feature extractor
            else:
                xt_local, _ = _apply(model, t_params, "local_features", wav, wav_pad)
            xt = xt_local + _apply(model, t_params, "positional", xt_local, fm)
            _, layer_ts = _apply(model, t_params, "contextualize", xt, fm, True)
            y = make_targets(layer_ts, pcfg)

        # clone_batch: M masks per clip. Every draw below is of the global
        # batch's rows (all_rows; a clip's clones stay together) in the
        # single-process order, given or from the generator, and cut to this
        # rank's rows
        m = max(1, pcfg.clone_batch)
        x_rep, fm_rep, y_rep = (torch.repeat_interleave(z, m, dim=0) if m > 1 else z
                                for z in (x_local, fm, y))
        rows = b * m
        all_rows, mine = rows, slice(None)
        if cut is not None:
            all_rows, mine = cut.batch * m, slice(cut.rows.start * m, cut.rows.stop * m)

        def drawn(given, draw: Callable):
            return _cut_rows(draw() if given is None else given, mine)

        if pcfg.mask_length == 1:
            u = drawn(None if draws.mask is None else draws.mask[0],
                      lambda: torch.rand((all_rows, t), generator=generator, device=dev))
            mask, n_masked = sample_random_mask(rows, t, pcfg.mask_prob, uniform=u, device=dev)
        else:
            uniforms = drawn(draws.mask, lambda: span_mask_uniforms(
                all_rows, t, pcfg.mask_length, generator, dev))
            mask, n_masked = sample_span_mask(
                rows, t, pcfg.mask_prob, pcfg.mask_length, pcfg.inverse_mask,
                lengths=(~fm_rep).sum(dim=1), uniforms=uniforms, device=dev)
        info = make_mask_info(mask, n_masked)
        normal = None
        if not pcfg.encoder_zero_mask:
            normal = drawn(draws.tok, lambda: torch.randn(
                (all_rows, t, d), generator=generator, device=dev, dtype=x_rep.dtype))
        x_masked = apply_mask(x_rep, info, pcfg.encoder_zero_mask, pcfg.mask_noise_std,
                              normal=normal)
        if pcfg.mask_channel_prob > 0:
            # channels span-masked per row and zeroed at every frame; they
            # reach the student only through the positional conv (kept
            # tokens are gathered from the features before masking)
            chan = drawn(draws.chan, lambda: span_mask_uniforms(
                all_rows, d, pcfg.mask_channel_length, generator, dev))
            ch_mask, _ = sample_span_mask(rows, d, pcfg.mask_channel_prob,
                                          pcfg.mask_channel_length, uniforms=chan, device=dev)
            x_masked = x_masked * (1.0 - ch_mask[:, None, :].to(x_masked.dtype))
        x_pos = _apply(model, params, "positional", x_masked, fm_rep)
        x_kept = gather_unmasked(x_rep, info) + gather_unmasked(x_pos, info)
        pm_kept = gather_unmasked_mask(fm_rep, info)
        x_enc, _ = _apply(model, params, "contextualize", x_kept, pm_kept, not train,
                          generator, None if cut is None else (all_rows, mine))

        # decoder input: dropout on the encoder outputs, then mask tokens
        rate = pcfg.decoder.input_dropout
        len_keep = x_enc.shape[1]
        if train and rate > 0:
            keep = None
            if rate < 1:
                keep = drawn(draws.din, lambda: draw_keep((all_rows, len_keep, d), rate,
                                                          generator, dev))
            x_enc = dropout(x_enc, rate, keep=keep).to(x_enc.dtype)
        dtok = drawn(draws.dtok, lambda: torch.randn(
            (all_rows, t - len_keep, d), generator=generator, device=dev, dtype=x_enc.dtype))
        dec_in = restore_with_mask_tokens(x_enc, info, pcfg.mask_noise_std, normal=dtok)
        pred = _apply(model, params, "decode", dec_in)

        w_frame = mask & ~fm_rep
        loss_frame = d2v_loss(pred, y_rep, w_frame, pcfg.loss_beta, pcfg.loss_scale, group)
        valid = (~fm_rep).float()[..., None]
        nv = torch.clamp(valid.sum(dim=1), min=1.0)
        pred_utt = (pred.float() * valid).sum(dim=1) / nv
        y_utt = (y_rep * valid).sum(dim=1) / nv
        loss_utt = d2v_loss(pred_utt, y_utt, torch.ones(rows, device=dev), pcfg.loss_beta,
                            pcfg.loss_scale, group)
        total = pcfg.d2v_loss * loss_frame + pcfg.cls_loss * loss_utt
        with torch.no_grad():
            metrics = {
                "loss": dp_sum(total, group),
                "d2v_loss": dp_sum(loss_frame, group),
                "cls_loss": dp_sum(loss_utt, group),
                # collapse telemetry over the masked valid tokens only
                "target_var": compute_var(y_rep, w_frame, group),
                "pred_var": compute_var(pred, w_frame, group),
                "masked_pct": dp_sum(w_frame.float().sum(), group) / float(all_rows * t),
            }
        return total, metrics

    return loss_fn


def make_d2v_eval_step(model: D2vPretrainModel):
    """(params, ema_blocks, wav, pad, generator=None, draws=None, cut=None)
    -> metrics with no update and no dropout (the validation pass)."""
    loss_fn = make_d2v_loss_fn(model, train=False)

    @torch.no_grad()
    def eval_fn(params, ema_blocks, wav, wav_pad, generator=None, draws=None, cut=None):
        _, metrics = loss_fn(params, ema_blocks, wav, wav_pad, generator, draws, cut)
        return metrics

    return eval_fn


KERNEL_IN_TRAINING = (
    "the attention kernel (ops/attention.py) is forward-only and cannot run "
    "in a differentiated d2v training step: set use_flash_attention=False "
    "(or 'auto' with crops under {n} frames); extraction and evaluation take "
    "the kernel as configured")


def check_trainable(cfg: EncoderConfig, pcfg: D2vPretrainConfig) -> None:
    """Raises ValueError when the config would send a differentiated block
    through the attention kernel: ``use_flash_attention`` True, or "auto"
    with the crop's frame count at the kernel's threshold or above."""
    frames = conv_frames(pcfg.crop_size, cfg.conv_feature_layers)
    flash = cfg.use_flash_attention
    if flash is True or (flash == "auto" and frames >= FLASH_AUTO_MIN_FRAMES):
        raise ValueError(KERNEL_IN_TRAINING.format(n=FLASH_AUTO_MIN_FRAMES))


def d2v_update(model: D2vPretrainModel, tx: D2vOptimizer, loss_fn, state: D2vTrainState,
               wav, wav_pad, generator=None, draws=None, cut: Optional[BatchCut] = None,
               reduce_grads: Optional[Callable[[Params], Params]] = None,
               grad_norm: Optional[Callable[[Params], Optional[torch.Tensor]]] = None):
    """One update: the loss, its gradient, the optimizer and the EMA.
    The process grid's step (``parallel/d2v_sharded.py``) gives its
    ``cut``, the sum of the gradients over dp (``reduce_grads``) and the
    global norm of sharded gradients (``grad_norm``, given with
    ``reduce_grads``). Spans
    ``d2v_pretrain.loss`` (the loss and its gradient) and
    ``d2v_pretrain.update`` (the optimizer and the EMA) time their issue."""
    with profiling.span("d2v_pretrain.loss"):
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        total, metrics = loss_fn(leaves, state.ema_blocks, wav, wav_pad, generator, draws, cut)
        grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
    with profiling.span("d2v_pretrain.update"), torch.no_grad():
        params = {k: v.detach() for k, v in leaves.items()}
        grads = dict(zip(leaves, grads))
        if reduce_grads is not None:
            grads = reduce_grads({k: torch.zeros_like(params[k]) if g is None else g
                                  for k, g in grads.items()})
        norm = None if grad_norm is None else grad_norm(grads)
        state, decay = optimizer_and_ema(tx, model.pcfg, state, params, grads, norm)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["ema_decay"] = decay
    return state, metrics


def make_d2v_train_step(model: D2vPretrainModel, tx: D2vOptimizer):
    """step(state, wav, wav_pad, generator=None, draws=None) -> (state',
    metrics): the loss, its gradient, the optimizer and the EMA update."""
    check_trainable(model.cfg, model.pcfg)
    loss_fn = make_d2v_loss_fn(model, train=True)

    def step(state: D2vTrainState, wav, wav_pad, generator=None, draws=None):
        return d2v_update(model, tx, loss_fn, state, wav, wav_pad, generator, draws)

    return step

