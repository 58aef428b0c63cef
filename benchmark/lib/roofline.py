"""Peaks of one NVIDIA H100 SXM and the operation counts of the encoder,
its attention calls and a d2v update, all from shapes.

Frozen copies of ``chip_smoke.py``'s ``bound``, ``attention_bound_ms`` and
``d2v_step_flops`` (the arithmetic, not the code that calls them); FLOPs
count 2 per multiply-add of matmuls and convolutions, elementwise work is
not counted."""

from __future__ import annotations

from typing import Sequence, Tuple

# Published H100 SXM dense peaks: bf16 tensor cores, f32 outside them, HBM3.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float, peak: float = PEAK_BF16) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the larger of the bytes over HBM
    bandwidth and the operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")


def attention_bound_s(batch: int, heads: int, n: int, head_dim: int, valid_keys: int,
                      itemsize: int = 2, peak: float = PEAK_BF16) -> float:
    """Least time of one attention call on (batch, heads, n, head_dim)
    operands: q, k, v and the output read or written once each plus the
    (batch, n) bool mask, against each query row's item's valid keys only
    (``valid_keys``: summed over the batch), QK^T and PV."""
    flops = 4.0 * heads * n * head_dim * valid_keys
    nbytes = 4.0 * batch * heads * n * head_dim * itemsize + batch * n
    return bound_s(nbytes, flops, peak)[0]


def conv_frames(n_samples: int, conv_layers: Sequence[Sequence[int]]) -> int:
    """Frames out of the conv front end for ``n_samples`` samples."""
    for _dim, kernel, stride in conv_layers:
        n_samples = (n_samples - kernel) // stride + 1
    return max(n_samples, 0)


def encoder_flops(enc: dict, n_samples: int) -> float:
    """Matmul and conv FLOPs of the frozen encoder's forward over one clip
    of ``n_samples`` samples at its own length (no padding): the conv front
    end, the projection, the positional convs and every block, attention
    over the clip's own frames."""
    e = enc["embed_dim"]
    h = int(e * enc["mlp_ratio"])
    n, c_in, total = n_samples, 1, 0.0
    for dim, k, s in enc["conv_feature_layers"]:
        n = (n - k) // s + 1
        if n <= 0:
            return 0.0
        total += 2.0 * n * dim * c_in * k
        c_in = dim
    t = n
    total += 2.0 * t * c_in * e
    kpos = max(3, enc["conv_pos_width"] // enc["conv_pos_depth"])
    total += 2.0 * t * e * (e // enc["conv_pos_groups"]) * kpos * enc["conv_pos_depth"]
    dense = 2.0 * (e * 3 * e + e * e + 2 * e * h)
    attn = 2.0 * 2 * t * e
    total += t * (dense + attn) * (enc["prenet_depth"] + enc["depth"])
    return total


def head_flops(head: dict, frames: int) -> float:
    """The DAD head over one clip: the pre-net at every frame, the
    classifier once."""
    return 2.0 * frames * head["input_dim"] * head["hidden_dim"] + \
        2.0 * head["hidden_dim"] * head["num_classes"]


def d2v_step_flops(enc: dict, d2v: dict, batch: int, frames: int, keep: int) -> float:
    """Matmul and convolution FLOPs of one d2v update: the conv front end
    and projection once per clip, forward and backward (x3); the teacher's
    positional conv and blocks forward only (x1) over every frame of B
    clips; the student's positional conv (all frames), blocks (the kept
    tokens) and decoder (all frames) over B x clone_batch rows, x3."""
    e, h = enc["embed_dim"], int(enc["embed_dim"] * enc["mlp_ratio"])
    rows = batch * d2v["clone_batch"]
    n, c_in, front = d2v["crop_size"], 1, 0.0
    for dim, k, s in enc["conv_feature_layers"]:
        n = (n - k) // s + 1
        front += 2.0 * batch * n * dim * c_in * k
        c_in = dim
    front += 2.0 * batch * frames * c_in * e
    kpos = max(3, enc["conv_pos_width"] // enc["conv_pos_depth"])
    pos = 2.0 * frames * e * (e // enc["conv_pos_groups"]) * kpos * enc["conv_pos_depth"]

    def blocks(tokens_per_row: int) -> float:
        dense = 2.0 * (e * 3 * e + e * e + 2 * e * h)
        attn = 2.0 * 2 * tokens_per_row * e
        return tokens_per_row * (dense + attn) * (enc["prenet_depth"] + enc["depth"])

    dc = d2v["decoder"]
    dec, c = 0.0, e
    for _ in range(dc["decoder_layers"]):
        dec += 2.0 * frames * dc["decoder_dim"] * (c // dc["decoder_groups"]) * dc["decoder_kernel"]
        c = dc["decoder_dim"]
    dec += 2.0 * frames * c * e
    teacher = batch * (pos + blocks(frames))
    student = rows * (pos + blocks(keep) + dec)
    return 3 * front + teacher + 3 * student


def dad_step_flops(head: dict, batch: int, t_clean: int, t_noisy: int) -> float:
    """Matmul FLOPs of one DAD feature step at its batches' padded shapes:
    the student over the clean batch and over the strong view, forward and
    backward (x3), the teacher over the weak view (x1), each the pre-net
    at every frame and the classifier once a row; ECDA's squared distances
    over the 2B embeddings, forward and backward."""
    d, h, c = head["input_dim"], head["hidden_dim"], head["num_classes"]

    def one(t: int) -> float:
        return 2.0 * batch * (t * d * h + h * c)

    return 3 * one(t_clean) + one(t_noisy) + 3 * one(t_noisy) + 3 * 2.0 * (2 * batch) ** 2 * h
