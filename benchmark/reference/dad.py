"""The DAD feature-level training step (the reference's
IEMOCAP/DAD-train-IEMOCAP: train.py's train_step and epoch scalars,
model.py's SSRLModel with its EMA teacher, utils.py's DataAugmentation,
DACPManager and ECDALoss), one update in float32 from the reference SSRL
checkpoint layout (``student_*`` and ``teacher_*`` keys), as the
configuration's ``dad`` settings state it:

- the head: Linear -> ReLU -> mean over valid frames (the embedding) ->
  dropout (the student only) -> Linear;
- CE with label smoothing over the clean batch's labelled rows;
- the noisy batch's weak view (+ N(0, weak^2)) through the teacher, its
  strong view (+ N(0, strong^2), one channel-dropout mask, a temporal mask
  of floor(0.1 x the batch's longest valid length) frames a row) through
  the student;
- DACP: certainty p_max (1 - H / log2 C), per class the quantile of the
  batch's scores at the epoch's level (the EMA threshold where the class
  is absent), + lambda (sigmoid(k (Q - mean Q)) - 0.5), floored at the
  anchors, EMA-smoothed; the mask is score >= its class's threshold;
- the masked KL consistency, and ECDA: per class the score-weighted
  multi-kernel MMD between the clean rows of the class and the masked
  noisy rows of that pseudo-label, plus compactness and the centroids'
  repulsion, weighted by exp(lambda (mean W - W_c));
- global-norm clipping, L2 decay into the gradient, Adam, then the
  teacher's EMA.

Every random number comes in as ``draws`` (the weak and strong noise, the
channel uniforms, the temporal mask starts, both dropout keeps)."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from . import nn as rnn

Params = Dict[str, torch.Tensor]
LEAVES = ("encoder.pre_net.weight", "encoder.pre_net.bias",
          "classifier.fc_layer.weight", "classifier.fc_layer.bias")


class State(NamedTuple):
    params: Params  # student_* and teacher_* leaves
    mu: Params  # the student's leaves, without the role prefix
    nu: Params
    count: int
    quality: torch.Tensor  # (C,)
    thresholds: torch.Tensor  # (C,)
    score_sums: torch.Tensor  # (C,)
    score_counts: torch.Tensor  # (C,)


def epoch_scalars(dad: dict, epoch: int) -> dict:
    """The reference's per-epoch loss weights, DACP quantile level and
    cosine learning rate."""
    warmup = epoch < dad["warmup_epochs"]
    w_cons = w_ecda = 0.0
    if not warmup:
        ramp = dad["weight_ramp_epochs"]
        if dad["progressive_training"]:
            p = min(1.0, (epoch - dad["warmup_epochs"]) / ramp)
            w_cons = dad["initial_consistency_weight"] + (
                dad["final_consistency_weight"] - dad["initial_consistency_weight"]) * p
        else:
            w_cons = dad["weight_consistency"]
        if epoch >= dad["ecda_start_epoch"]:
            w_ecda = dad["weight_ecda"] * min(1.0, (epoch - dad["ecda_start_epoch"]) / ramp)
    dc = dad["dacp"]
    gamma = dc["quantile_start"] + (dc["quantile_end"] - dc["quantile_start"]) * epoch / dad["epochs"]
    lr = dad["learning_rate"]
    if dad["lr_scheduler"] == "cosine":
        lr = 0.5 * lr * (1.0 + math.cos(math.pi * epoch / dad["epochs"]))
    return dict(warmup=warmup, w_cons=w_cons, w_ecda=w_ecda, gamma=gamma, lr=lr)


class DadReference:
    def __init__(self, dad: dict, q: rnn.Q = rnn.exact):
        self.c, self.q = dad, q

    def init(self, params: Params, count: int) -> State:
        C = self.c["num_classes"]
        dev = next(iter(params.values())).device

        def full(v):
            return torch.full((C,), v, dtype=torch.float32, device=dev)

        student = {k: params[f"student_{k}"] for k in LEAVES}
        return State({k: v.detach().float().clone() for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in student.items()},
                     {k: torch.zeros_like(v) for k, v in student.items()},
                     count, full(0.5), full(0.5), full(0.0), full(0.0))

    # -- the head -------------------------------------------------------------
    def head(self, p: Params, role: str, feats, pad, keep=None):
        """(logits, embeddings) of ``role``'s head."""
        h = torch.relu(rnn.linear(feats, p[f"{role}_encoder.pre_net.weight"],
                                  p[f"{role}_encoder.pre_net.bias"], self.q))
        m = (~pad).float()[..., None]
        emb = (h * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
        x = rnn.dropout(emb, keep, self.c["dropout_rate"])
        return rnn.linear(x, p[f"{role}_classifier.fc_layer.weight"],
                          p[f"{role}_classifier.fc_layer.bias"], self.q), emb

    def predict(self, p: Params, role: str, feats, pad) -> torch.Tensor:
        with rnn.strict_f32(), torch.no_grad():
            return self.head(p, role, feats, pad)[0].argmax(dim=-1)

    # -- augmentation, DACP, ECDA ----------------------------------------------
    def strong(self, x, pad, draws):
        a = self.c["augment"]
        out = x + draws["strong_noise"] * a["strong_noise_std"]
        if a["feature_dropout_rate"] > 0:
            out = out * (draws["feat_u"] > a["feature_dropout_rate"]).float()
        mlen = int(math.floor(float((~pad).sum(dim=1).max()) * a["temporal_mask_ratio"]))
        if mlen > 0:
            pos = torch.arange(x.shape[1], device=x.device)[None, :]
            start = draws["start"][:, None]
            out = torch.where(((pos >= start) & (pos < start + mlen))[..., None],
                              torch.zeros((), device=x.device), out)
        return out

    def dacp(self, s: State, probs, valid, gamma: float, anchors):
        c, C = self.c["dacp"], probs.shape[1]
        preds = probs.argmax(dim=1)
        ent = -(probs * torch.log2(probs + 1e-8)).sum(dim=1)
        scores = probs.amax(dim=1) * (1.0 - ent / math.log2(C))
        wce = torch.sigmoid(c["sensitivity_k"] * (s.quality - s.quality.mean()))
        thr = torch.stack([torch.quantile(scores[(preds == k) & valid], gamma)
                           if bool(((preds == k) & valid).any()) else s.thresholds[k]
                           for k in range(C)])
        dyn = torch.maximum(thr + c["calibration_strength_lambda"] * (wce - 0.5), anchors)
        a = c["threshold_smoothing_alpha"]
        new = a * s.thresholds + (1.0 - a) * dyn
        mask = (scores >= new[preds]) & valid
        member = torch.nn.functional.one_hot(preds, C).float() * valid[:, None].float()
        return new, mask, scores, preds, wce, member.T @ scores, member.sum(dim=0)

    def mmd(self, src, tgt, w_t):
        """(ss, tt, st) of the multi-kernel MMD, the bandwidth the mean
        squared distance over the pairs of both sets, no gradient."""
        e = self.c["ecda"]
        both = torch.cat([src, tgt])
        d2 = ((both[None, :, :] - both[:, None, :]) ** 2).sum(dim=-1)
        n = both.shape[0]
        bw = d2.detach().sum() / (n * n - n) / e["kernel_mul"] ** (e["kernel_num"] // 2)
        k = sum(torch.exp(-d2 / (bw * e["kernel_mul"] ** i + 1e-8)) for i in range(e["kernel_num"]))
        ns = src.shape[0]
        w_s = torch.ones(ns, device=src.device)

        def term(kk, wa, wb):
            w = torch.outer(wa, wb)
            return (kk * w).sum() / (w.sum() + 1e-8)
        return term(k[:ns, :ns], w_s, w_s), term(k[ns:, ns:], w_t, w_t), term(k[:ns, ns:], w_s, w_t)

    def ecda(self, clean_emb, labels, clean_valid, noisy_emb, pseudo, mask, scores, wce):
        e, C = self.c["ecda"], self.c["num_classes"]
        cents = [noisy_emb[(pseudo == k) & mask].mean(dim=0) for k in range(C)
                 if bool(((pseudo == k) & mask).any())]
        rep = -torch.pdist(torch.stack(cents)).mean() if len(cents) > 1 else \
            torch.zeros((), device=clean_emb.device)
        attn = torch.exp(e["class_attention_lambda"] * (wce.mean() - wce))
        total = torch.zeros((), device=clean_emb.device)
        for k in range(C):
            src = clean_emb[(labels == k) & clean_valid]
            sel = (pseudo == k) & mask
            tgt = noisy_emb[sel]
            if src.shape[0] < 2 or tgt.shape[0] < 2:
                continue
            ss, tt, st = self.mmd(src, tgt, scores[sel])
            compact = ((tgt - tgt.mean(dim=0)) ** 2).sum(dim=1).mean()
            total = total + attn[k] * (ss + tt - 2 * st + e["compactness_weight_gamma"] * compact
                                       + e["repulsion_weight_delta"] * rep)
        return total

    # -- the update -----------------------------------------------------------
    def step(self, s: State, clean: dict, noisy: dict, draws: dict, sc: dict, anchors):
        """One update from the batches (feats, pad, labels, valid) and the
        epoch's scalars. Returns (state', total loss)."""
        c, C = self.c, self.c["num_classes"]
        with rnn.strict_f32():
            leaves = {k: s.params[f"student_{k}"].detach().requires_grad_(True) for k in LEAVES}
            p = {**s.params, **{f"student_{k}": v for k, v in leaves.items()}}
            logits, clean_emb = self.head(p, "student", clean["feats"], clean["pad"],
                                          draws["clean_keep"])
            eps = c["label_smoothing_factor"] if c["use_label_smoothing"] else 0.0
            onehot = torch.nn.functional.one_hot(clean["labels"].clamp(min=0), C).float()
            row = -((onehot * (1 - eps) + eps / C) * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
            w = clean["valid"].float()
            total = (row * w).sum() / w.sum().clamp(min=1.0)
            new_thr, mask = s.thresholds, None
            sums, counts = s.score_sums, s.score_counts
            if not sc["warmup"]:
                a = c["augment"]
                weak = noisy["feats"] + draws["weak"] * a["weak_noise_std"]
                strong = self.strong(noisy["feats"], noisy["pad"], draws)
                with torch.no_grad():
                    tprobs = torch.softmax(self.head(p, "teacher", weak, noisy["pad"])[0], dim=-1)
                new_thr, mask, scores, pseudo, wce, ds, dn = self.dacp(
                    s, tprobs, noisy["valid"], sc["gamma"], anchors)
                sums, counts = sums + ds, counts + dn
                slog, strong_emb = self.head(p, "student", strong, noisy["pad"],
                                             draws["strong_keep"])
                kl = (tprobs * (torch.log(tprobs + 1e-12) - torch.log_softmax(slog, dim=-1))).sum(-1)
                n = mask.float().sum()
                if n > 1:
                    total = total + sc["w_cons"] * (kl * mask.float()).sum() / (n + 1e-8)
                    if c["ecda"]["use_ecda"] and sc["w_ecda"] > 0:
                        total = total + sc["w_ecda"] * self.ecda(
                            clean_emb, clean["labels"], clean["valid"], strong_emb, pseudo, mask,
                            scores, wce)
            grads = torch.autograd.grad(total, list(leaves.values()))
        with torch.no_grad():
            g = dict(zip(LEAVES, grads))
            norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
            if c["gradient_clipping"] and norm >= c["max_grad_norm"]:
                g = {k: x / norm * c["max_grad_norm"] for k, x in g.items()}
            g = {k: x + c["weight_decay"] * leaves[k] for k, x in g.items()}
            b1, b2 = 0.9, 0.999
            mu = {k: (1 - b1) * g[k] + b1 * s.mu[k] for k in LEAVES}
            nu = {k: (1 - b2) * g[k] * g[k] + b2 * s.nu[k] for k in LEAVES}
            count = s.count + 1
            c1, c2 = 1 - b1 ** count, 1 - b2 ** count
            params = dict(s.params)
            for k in LEAVES:
                params[f"student_{k}"] = leaves[k].detach() - sc["lr"] * (
                    (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8))
            if not sc["warmup"]:
                m = c["ema_momentum"]
                for k in LEAVES:
                    params[f"teacher_{k}"] = m * params[f"teacher_{k}"] + (1 - m) * params[f"student_{k}"]
        return State(params, mu, nu, count, s.quality, new_thr, sums, counts), float(total.detach())
