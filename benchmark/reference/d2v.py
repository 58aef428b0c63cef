"""data2vec 2.0 pretraining of the emotion2vec encoder (arXiv:2212.07525,
arXiv:2312.15185), one update in float32, as the JAX package's
``D2vPretrainConfig`` defaults state it:

- the student's conv front end and projection over B 10 s crops; the
  teacher (the student with the EMA copies of the 8 main blocks) over the
  unmasked clip, no gradient; its targets the mean of the 8 main blocks'
  FFN outputs, each instance-normed over time;
- ``clone_batch`` masks a clip: spans of 5 at 0.7 with the same masked
  count in every row (span union ranked first, uniform fill to the count),
  masked inputs zeroed; the student's positional conv over the masked
  sequence, its 12 blocks over the kept tokens (dropout in training);
- the decoder's input: dropout, then N(0, 0.01) mask tokens restored to
  their places; 5 grouped convs (k 5, 16 groups, 384 wide) with residuals,
  then a projection to 768;
- the loss: the 1/sqrt(D)-scaled L2 at masked valid frames plus the same
  over the valid-frame means; the gradient clipped to a global norm of 4;
  AdamW (optax's order, warmup-cosine learning rate); the EMA of the main
  blocks.

The masks' uniforms, the decoder's input keep and the mask tokens come in
as ``draws``, and the blocks' dropout keeps from ``generator``, drawn in
the order the blocks use them (per block: the attention probabilities,
the attention output, the MLP output), so that the program fed the same
draws and a generator in the same state computes the same update."""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import nn as rnn

Params = Dict[str, torch.Tensor]


class State(NamedTuple):
    params: Params
    ema: Params
    mu: Params
    nu: Params
    count: int


def span_mask_counts(t: int, mask_prob: float, mask_length: int) -> Tuple[int, int]:
    n_spans = max(1, int(mask_prob * t / float(mask_length) + 0.5))
    return n_spans, min(n_spans * mask_length, t - 1)


def span_mask(t: int, mask_prob: float, mask_length: int, lengths: torch.Tensor,
              uniforms) -> Tuple[torch.Tensor, int]:
    """Spans starting at the lowest start noise among each row's valid
    starts; their union first, then the fill noise, up to the same masked
    count in every row; padding only overflows."""
    n_spans, n_masked = span_mask_counts(t, mask_prob, mask_length)
    noise, fill = uniforms
    dev = noise.device
    start_pos = torch.arange(t - mask_length + 1, device=dev)
    valid_start = start_pos[None, :] < torch.clamp(lengths[:, None] - mask_length + 1, min=1)
    noise = noise + 2.0 * (~valid_start)
    starts = torch.argsort(noise, dim=1, stable=True)[:, :n_spans]
    pos = torch.arange(t, device=dev)
    inside = (pos[None, None, :] >= starts[:, :, None]) & (pos[None, None, :] < starts[:, :, None] + mask_length)
    score = inside.any(dim=1).float() * 2.0 + fill
    score = score - 8.0 * (pos[None, :] >= lengths[:, None])
    ranks = torch.argsort(torch.argsort(-score, dim=1, stable=True), dim=1, stable=True)
    return ranks < n_masked, n_masked


def _gather(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:
        return torch.gather(x, 1, ids)
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


class D2vReference:
    """The update of ``enc`` (the encoder's sizes) and ``d2v`` (the
    pretraining settings), as plain dicts of the configuration file."""

    def __init__(self, enc: dict, d2v: dict, q: rnn.Q = rnn.exact):
        if enc["activation_dropout"] not in (0, 0.0) or enc["layerdrop"] or enc["prenet_layerdrop"]:
            raise ValueError("the reference has no MLP dropout or layerdrop")
        self.enc, self.d2v, self.q = enc, d2v, q
        self.blocks = [f"prenet_block_{i}" for i in range(enc["prenet_depth"])]
        self.blocks += [f"block_{i}" for i in range(enc["depth"])]
        self.rates = (enc["attention_dropout"], enc["encoder_dropout"], enc["post_mlp_drop"])

    # -- the model ---------------------------------------------------------
    def local(self, p: Params, wav, pad):
        enc, q = self.enc, self.q
        x = rnn.front_end(wav, p, lambda i: (f"local_encoder.conv_{i}.weight",
                                              f"local_encoder.ln_{i}.weight",
                                              f"local_encoder.ln_{i}.bias"),
                          enc["conv_feature_layers"], q)
        x = rnn.layer_norm(x, p["proj_ln.weight"], p["proj_ln.bias"], 1e-5)
        x = rnn.linear(x, p["proj.weight"], p["proj.bias"], q)
        lengths = rnn.out_lengths((~pad).sum(dim=-1), enc["conv_feature_layers"])
        fm = torch.arange(x.shape[1], device=x.device)[None, :] >= lengths[:, None]
        return x, fm

    def positional(self, p: Params, x, fm):
        enc = self.enc
        ws = [(p[f"pos_conv.pos_conv_{i}.weight"], p[f"pos_conv.pos_conv_{i}.bias"])
              for i in range(enc["conv_pos_depth"])]
        return rnn.positional(x, fm, ws, self.q, enc["conv_pos_groups"])

    def context(self, p: Params, x, fm, generator: Optional[torch.Generator]):
        """The prenet LayerNorm and the 12 blocks; dropout keeps from
        ``generator`` when given. Returns (x, the main blocks' FFN outputs)."""
        enc = self.enc
        x = rnn.layer_norm(x, p["prenet_ln.weight"], p["prenet_ln.bias"], enc["norm_eps"])
        targets = []
        for name in self.blocks:
            keeps = None if generator is None else self.draw_keeps(x, generator)
            x, t = rnn.block(x, fm, p, name, enc["num_heads"], enc["norm_eps"], self.q,
                             keeps, self.rates)
            if not name.startswith("prenet"):
                targets.append(t)
        return x, targets

    def draw_keeps(self, x, generator):
        B, N, C = x.shape
        a, o, post = self.rates
        shapes = ((B, self.enc["num_heads"], N, N), a), ((B, N, C), o), ((B, N, C), post)
        return [torch.rand(s, generator=generator, device=x.device) < 1.0 - r if 0 < r < 1
                else None for s, r in shapes]

    def decoder(self, p: Params, x):
        dc, q = self.d2v["decoder"], self.q
        residual = x
        for i in range(dc["decoder_layers"]):
            w = p[f"decoder.conv_{i}.weight"]
            k = w.shape[-1]
            x = rnn.conv_btc(x, w, p[f"decoder.conv_{i}.bias"], q, padding=k // 2,
                             groups=dc["decoder_groups"])
            if k % 2 == 0:
                x = x[:, :-1]
            x = rnn.gelu(rnn.layer_norm(x, None, None, 1e-5))
            if dc["decoder_residual"] and residual.shape[-1] == x.shape[-1]:
                x = x + residual
            residual = x
        for i in range(dc["projection_layers"] - 1):
            x = rnn.gelu(rnn.linear(x, p[f"decoder.proj_{i}.weight"], p[f"decoder.proj_{i}.bias"], q))
        return rnn.linear(x, p["decoder.proj_out.weight"], p["decoder.proj_out.bias"], q)

    # -- the objective ------------------------------------------------------
    def targets(self, layer_ts: List[torch.Tensor]) -> torch.Tensor:
        tl = layer_ts[-self.d2v["average_top_k_layers"]:]
        tl = [(t - t.mean(dim=1, keepdim=True)) / torch.sqrt(t.var(dim=1, keepdim=True, unbiased=False) + 1e-5)
              for t in tl]
        return sum(tl) / len(tl)

    def loss(self, p: Params, ema: Params, wav, pad, draws: dict,
             generator: torch.Generator) -> torch.Tensor:
        d2v = self.d2v
        x_local, fm = self.local(p, wav, pad)
        b, t, d = x_local.shape
        with torch.no_grad():
            tp = {**{k: v.detach() for k, v in p.items()}, **ema}
            xt = x_local.detach()
            xt = xt + self.positional(tp, xt, fm)
            _, layer_ts = self.context(tp, xt, fm, None)
            y = self.targets(layer_ts)
        m = d2v["clone_batch"]
        x_rep, fm_rep, y_rep = (torch.repeat_interleave(z, m, dim=0) for z in (x_local, fm, y))
        mask, n_masked = span_mask(t, d2v["mask_prob"], d2v["mask_length"],
                                   (~fm_rep).sum(dim=1), draws["mask"])
        ids_shuffle = torch.argsort(mask.to(torch.int32), dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :t - n_masked]
        x_masked = x_rep * (1.0 - mask[..., None].float())
        x_pos = self.positional(p, x_masked, fm_rep)
        x_kept = _gather(x_rep, ids_keep) + _gather(x_pos, ids_keep)
        x_enc, _ = self.context(p, x_kept, _gather(fm_rep, ids_keep), generator)
        x_enc = rnn.dropout(x_enc, draws["din"], d2v["decoder"]["input_dropout"])
        dec_in = _gather(torch.cat([x_enc, d2v["mask_noise_std"] * draws["dtok"]], dim=1), ids_restore)
        pred = self.decoder(p, dec_in)
        scale = 1.0 / math.sqrt(d)
        w = (mask & ~fm_rep).float()
        frame = (((pred - y_rep) ** 2).sum(dim=-1) * scale * w).sum() / torch.clamp(w.sum(), min=1.0)
        valid = (~fm_rep).float()[..., None]
        nv = torch.clamp(valid.sum(dim=1), min=1.0)
        utt_d = (pred * valid).sum(dim=1) / nv - (y_rep * valid).sum(dim=1) / nv
        utt = ((utt_d ** 2).sum(dim=-1) * scale).sum() / float(b * m)
        return d2v["d2v_loss"] * frame + d2v["cls_loss"] * utt

    # -- the update ---------------------------------------------------------
    def init(self, params: Params, ema: Optional[Params] = None, count: int = 0) -> State:
        """The state at step ``count`` with Adam's moments zero; ``ema``:
        the main blocks' EMA copies (None: copies of ``params``)."""
        if ema is None:
            ema = {k: v for k, v in params.items() if k.split(".")[0] in
                   {f"block_{i}" for i in range(self.enc["depth"])}}
        return State({k: v.detach().float().clone() for k, v in params.items()},
                     {k: v.detach().float().clone() for k, v in ema.items()},
                     {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()},
                     {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()},
                     count)

    def learning_rate(self, count: int) -> float:
        d2v = self.d2v
        warmup = min(d2v["warmup_steps"], max(d2v["max_steps"] - 1, 0))
        decay_steps = max(d2v["max_steps"], warmup + 1)
        if warmup > 0 and count < warmup:
            return d2v["learning_rate"] * count / warmup
        k = min(count - warmup, decay_steps - warmup)
        return d2v["learning_rate"] * 0.5 * (1 + math.cos(math.pi * k / (decay_steps - warmup)))

    def step(self, state: State, wav, pad, draws: dict, generator: torch.Generator):
        """One update in float32 without TF32. Returns (state', loss)."""
        d2v = self.d2v
        with rnn.strict_f32():
            leaves = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
            total = self.loss(leaves, state.ema, wav, pad, draws, generator)
            grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
        with torch.no_grad():
            g = {k: torch.zeros_like(v) if gi is None else gi for (k, v), gi in zip(leaves.items(), grads)}
            norm = torch.sqrt(sum((gi * gi).sum() for gi in g.values()))
            if norm >= d2v["grad_clip"]:
                g = {k: gi / norm * d2v["grad_clip"] for k, gi in g.items()}
            b1, b2 = d2v["adam_betas"]
            mu = {k: (1 - b1) * g[k] + b1 * state.mu[k] for k in g}
            nu = {k: (1 - b2) * g[k] * g[k] + b2 * state.nu[k] for k in g}
            count = state.count + 1
            c1, c2 = 1 - b1 ** count, 1 - b2 ** count
            lr = self.learning_rate(state.count)
            params = {k: p - lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8)
                                   + d2v["weight_decay"] * p)
                      for k, p in state.params.items()}
            frac = min(max(state.count / max(d2v["ema_anneal_end_step"], 1), 0.0), 1.0)
            decay = d2v["ema_end_decay"] - (d2v["ema_end_decay"] - d2v["ema_decay"]) * (1 - frac)
            ema = {k: decay * e + (1 - decay) * params[k] for k, e in state.ema.items()}
        return State(params, ema, mu, nu, count), float(total.detach())
