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
  its storage dtype.

State is plain dicts of tensors keyed as ``D2vPretrainModel.state_dict()``
(``torch.func.functional_call`` runs the model on them). The student's
encoder keys are ``Emotion2vecEncoder``'s, so ``encoder_params`` loads into
the extraction encoder.

Random draws (masks, mask-token noise, dropout) come from an explicit
``torch.Generator``, or ready-made through ``D2vDraws`` (the tests feed
the JAX draws there). The attention kernel is forward-only:
``make_d2v_train_step`` refuses a config that would send a differentiated
block through it.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..configs import D2vPretrainConfig, EncoderConfig
from .d2v_masking import (
    apply_mask,
    gather_unmasked,
    gather_unmasked_mask,
    make_mask_info,
    restore_with_mask_tokens,
    sample_random_mask,
    sample_span_mask,
)
from .emotion2vec import make_block, run_block, torch_dtype
from .layers import (
    FLASH_AUTO_MIN_FRAMES,
    Conv,
    ConvFeatureExtractor,
    Dense,
    PositionalConv,
    convert_padding_mask,
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
    ``functional_call`` can run any of them on a params dict."""

    def __init__(self, cfg: EncoderConfig, pcfg: D2vPretrainConfig):
        super().__init__()
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
            self.add_module(name, make_block(cfg, return_ffn_target=True))
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
                      generator: Optional[torch.Generator] = None):
        """prenet LN + prenet blocks + main blocks -> (x, the main blocks'
        FFN targets). With ``pcfg.remat_blocks`` a differentiated block is
        recomputed in the backward (its dropout masks drawn before it)."""
        remat = self.pcfg.remat_blocks and torch.is_grad_enabled()
        x = self.prenet_ln(x).to(self.dtype)
        targets = []
        for name in self.block_names:
            x, t = run_block(getattr(self, name), x, frame_mask, None, deterministic,
                             generator, remat=remat)
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


def d2v_loss(pred: torch.Tensor, target: torch.Tensor, weight: torch.Tensor, beta: float,
             scale: Optional[float]) -> torch.Tensor:
    """1/sqrt(D)-scaled L2 (beta 0) or smooth-L1 regression in f32,
    averaged over the weighted positions."""
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
    return (per_pos * w).sum() / torch.clamp(w.sum(), min=1.0)


def compute_var(y: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sqrt(per-dim unbiased variance across tokens + 1e-6), averaged over
    dims: the collapse guards' statistic, over ``valid`` tokens only when
    given."""
    z = y.reshape(-1, y.shape[-1]).float()
    if valid is None:
        n = float(max(z.shape[0], 1))
        mu = z.mean(dim=0)
        var = ((z - mu) ** 2).sum(dim=0) / max(n - 1.0, 1.0)
    else:
        w = valid.reshape(-1, 1).float()
        n = torch.clamp(w.sum(), min=1.0)
        mu = (z * w).sum(dim=0) / n
        var = (w * (z - mu) ** 2).sum(dim=0) / torch.clamp(n - 1.0, min=1.0)
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

    def init(self, params: Params) -> D2vAdamState:
        device = next(iter(params.values())).device
        return D2vAdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(v, dtype=self.mu_dtype) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
        )

    def update(self, grads: Params, state: D2vAdamState, params: Params
               ) -> Tuple[Params, D2vAdamState]:
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
        count = state.count + 1
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        step = -self.learning_rate(state.count)
        updates = {k: step * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
                              + self.weight_decay * params[k]) for k in grads}
        if self.mu_dtype is not None:
            mu = {k: v.to(self.mu_dtype) for k, v in mu.items()}
        return updates, D2vAdamState(count, mu, nu)


def build_d2v_optimizer(pcfg: D2vPretrainConfig) -> D2vOptimizer:
    return D2vOptimizer(pcfg)


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


def conv_frames(n_samples: int, conv_layers) -> int:
    """Frames out of the conv front end for ``n_samples`` samples."""
    for _dim, kernel, stride in conv_layers:
        n_samples = (n_samples - kernel) // stride + 1
    return n_samples


def make_d2v_loss_fn(model: D2vPretrainModel, train: bool = True):
    """The d2v objective as a function of (params, ema_blocks, wav, wav_pad,
    generator=None, draws=None) -> (total, metrics). ``train=False`` turns
    the dropouts off (validation); the masks still draw."""
    pcfg = model.pcfg

    def loss_fn(params: Params, ema_blocks: Params, wav: torch.Tensor, wav_pad: torch.Tensor,
                generator: Optional[torch.Generator] = None, draws: Optional[D2vDraws] = None):
        draws = draws or D2vDraws()
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

        # clone_batch: M masks per clip
        m = max(1, pcfg.clone_batch)
        x_rep, fm_rep, y_rep = (torch.repeat_interleave(z, m, dim=0) if m > 1 else z
                                for z in (x_local, fm, y))
        rows = b * m

        if pcfg.mask_length == 1:
            mask, n_masked = sample_random_mask(
                rows, t, pcfg.mask_prob, generator,
                None if draws.mask is None else draws.mask[0], device=dev)
        else:
            mask, n_masked = sample_span_mask(
                rows, t, pcfg.mask_prob, pcfg.mask_length, pcfg.inverse_mask,
                lengths=(~fm_rep).sum(dim=1), generator=generator, uniforms=draws.mask,
                device=dev)
        info = make_mask_info(mask, n_masked)
        x_masked = apply_mask(x_rep, info, pcfg.encoder_zero_mask, pcfg.mask_noise_std,
                              generator, draws.tok)
        if pcfg.mask_channel_prob > 0:
            # channels span-masked per row and zeroed at every frame; they
            # reach the student only through the positional conv (kept
            # tokens are gathered from the features before masking)
            ch_mask, _ = sample_span_mask(rows, d, pcfg.mask_channel_prob,
                                          pcfg.mask_channel_length, generator=generator,
                                          uniforms=draws.chan, device=dev)
            x_masked = x_masked * (1.0 - ch_mask[:, None, :].to(x_masked.dtype))
        x_pos = _apply(model, params, "positional", x_masked, fm_rep)
        x_kept = gather_unmasked(x_rep, info) + gather_unmasked(x_pos, info)
        pm_kept = gather_unmasked_mask(fm_rep, info)
        x_enc, _ = _apply(model, params, "contextualize", x_kept, pm_kept, not train,
                          generator)

        # decoder input: dropout on the encoder outputs, then mask tokens
        rate = pcfg.decoder.input_dropout
        if train and rate > 0:
            x_enc = dropout(x_enc, rate, generator, draws.din).to(x_enc.dtype)
        dec_in = restore_with_mask_tokens(x_enc, info, pcfg.mask_noise_std, generator,
                                          draws.dtok)
        pred = _apply(model, params, "decode", dec_in)

        w_frame = mask & ~fm_rep
        loss_frame = d2v_loss(pred, y_rep, w_frame, pcfg.loss_beta, pcfg.loss_scale)
        valid = (~fm_rep).float()[..., None]
        nv = torch.clamp(valid.sum(dim=1), min=1.0)
        pred_utt = (pred.float() * valid).sum(dim=1) / nv
        y_utt = (y_rep * valid).sum(dim=1) / nv
        loss_utt = d2v_loss(pred_utt, y_utt, torch.ones(rows, device=dev), pcfg.loss_beta,
                            pcfg.loss_scale)
        total = pcfg.d2v_loss * loss_frame + pcfg.cls_loss * loss_utt
        metrics = {
            "loss": total,
            "d2v_loss": loss_frame,
            "cls_loss": loss_utt,
            # collapse telemetry over the masked valid tokens only
            "target_var": compute_var(y_rep, w_frame),
            "pred_var": compute_var(pred, w_frame),
            "masked_pct": w_frame.float().mean(),
        }
        return total, metrics

    return loss_fn


def make_d2v_eval_step(model: D2vPretrainModel):
    """(params, ema_blocks, wav, pad, generator=None, draws=None) -> metrics
    with no update and no dropout (the validation pass)."""
    loss_fn = make_d2v_loss_fn(model, train=False)

    @torch.no_grad()
    def eval_fn(params, ema_blocks, wav, wav_pad, generator=None, draws=None):
        _, metrics = loss_fn(params, ema_blocks, wav, wav_pad, generator, draws)
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


def make_d2v_train_step(model: D2vPretrainModel, tx: D2vOptimizer):
    """step(state, wav, wav_pad, generator=None, draws=None) -> (state',
    metrics): the loss, its gradient, the optimizer and the EMA update."""
    check_trainable(model.cfg, model.pcfg)
    pcfg = model.pcfg
    loss_fn = make_d2v_loss_fn(model, train=True)

    def step(state: D2vTrainState, wav, wav_pad, generator=None, draws=None):
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        total, metrics = loss_fn(leaves, state.ema_blocks, wav, wav_pad, generator, draws)
        grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
        with torch.no_grad():
            params = {k: v.detach() for k, v in leaves.items()}
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(leaves, grads)}
            updates, opt_state = tx.update(grads, state.opt_state, params)
            params = {k: p + updates[k] for k, p in params.items()}
            decay = annealed_decay(pcfg, state.step)
            # EMA arithmetic in f32 whatever the storage dtype
            ema = {k: (decay * e.float() + (1.0 - decay) * params[k].float()).to(e.dtype)
                   for k, e in state.ema_blocks.items()}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["ema_decay"] = decay
        return D2vTrainState(params, ema, opt_state, state.step + 1), metrics

    return step


def make_d2v_chunk_runner(model: D2vPretrainModel, tx: D2vOptimizer):
    """run(state, wavs (k, B, T), pads (k, B, T), generator=None,
    draws=None) -> (state', metrics stacked (k,)): k train steps in a loop,
    the same as k calls of the step. ``draws``: a list of k D2vDraws (or
    None)."""
    step = make_d2v_train_step(model, tx)

    def run(state: D2vTrainState, wavs, pads, generator=None,
            draws: Optional[List[Optional[D2vDraws]]] = None):
        per_step = []
        for i in range(wavs.shape[0]):
            state, m = step(state, wavs[i], pads[i], generator,
                            None if draws is None else draws[i])
            per_step.append(m)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return run

