"""Device-resident training corpus: the fold's clips held in device memory
once, each batch gathered there from a small index vector.

The trainers' training corpora are static for a whole run: the feature
trainer's clean and noisy stores, and the fused trainer's cached clean
features and the raw waveforms it injects noise into every step. Streaming
them re-ships the same bytes every step; here they are uploaded once per
fold, and per step the host sends two (B,) int32 index vectors.

Layout: the host stores' flat (total, ...) + (offset, size) layout, with no
per-clip padding on the device. A gather assembles the padded (B, T[, D])
batch, bit-equal to the host's: zero fill, True = pad masks, -1 labels and
ids on padded rows, the same frame cap. The JAX package pads each 1-D clip
slot to 128 samples for a TPU gather's speed; that changes no value and is
not done here.

The runners (``make_resident_*_epoch_runner``) loop over a chunk of steps
on the device, as ``dad/epoch_scan.py`` does for streamed chunks. Over a
mesh every rank holds the whole corpus (replicated, as in the JAX
package), gathers the global batch pair and hands it to the fused mesh
step, which takes the rank's rows. The d2v
pretraining corpus (``resident_from_flat``, ``make_resident_d2v_step``)
gathers fixed-size crops from per-row start offsets.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..data.batching import Batch, epoch_order, pad_to_bucket
from ..dad.epoch_scan import pad_draws
from ..dad.train_step import StepDraws, make_dad_train_step
from ..utils import get_logger
from .fused import CleanFeatureBatch, FusedBatch, FusedConfig, make_fused_extract_train_step

logger = get_logger(__name__)

DType = Union[str, torch.dtype, None]


class ResidentClips(NamedTuple):
    """A flat clip corpus on the device: ``flat`` is (total_samples,) for
    waveforms or (total_frames, D) for features; clip i is
    ``flat[offsets[i]:offsets[i] + sizes[i]]``."""

    flat: torch.Tensor
    offsets: torch.Tensor  # (N,) int64
    sizes: torch.Tensor  # (N,) int64
    labels: torch.Tensor  # (N,) int32, -1 where absent

    @property
    def num(self) -> int:
        return int(self.sizes.shape[0])


def store_flat(store) -> np.ndarray:
    """The flat backing array of a FeatureStore or a WavStore."""
    return store.feats if hasattr(store, "feats") else store.samples


def _compact(store) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Contiguous (flat, offsets, sizes) of a store that may be a subset
    view: only the subset's clips are uploaded."""
    sizes = np.asarray(store.sizes, np.int64)
    total = int(sizes.sum())
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    flat = store_flat(store)
    if total == 0:
        flat = flat[:0]
    elif not (np.array_equal(np.asarray(store.offsets, np.int64), offsets)
              and total == len(flat)):
        flat = np.concatenate([store.clip(i) for i in range(store.num)], axis=0)
    return flat, offsets, sizes


def _torch_dtype(dtype: DType) -> Optional[torch.dtype]:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def resident_from_store(store, device, dtype: DType = None,
                        labeled: bool = True) -> ResidentClips:
    """Uploads a WavStore / FeatureStore (or a subset view) to ``device``.

    ``dtype``: the storage dtype of ``flat`` (default: the store's).
    bfloat16 is lossless for features of a bfloat16 encoder, whose f32
    values are bf16 values, and halves the memory."""
    flat, offsets, sizes = _compact(store)
    labels = (np.asarray(store.labels, np.int32) if labeled and store.labels is not None
              else np.full(store.num, -1, np.int32))
    dev_flat = torch.from_numpy(np.ascontiguousarray(flat)).to(device)
    if dtype is not None:
        dev_flat = dev_flat.to(_torch_dtype(dtype))
    res = ResidentClips(
        flat=dev_flat,
        offsets=torch.from_numpy(offsets).to(device),
        sizes=torch.from_numpy(sizes).to(device),
        labels=torch.from_numpy(labels).to(device),
    )
    logger.info("resident corpus: %d clips, %.1f MB %s committed to %s", store.num,
                dev_flat.nbytes / 1e6, dev_flat.dtype, device)
    return res


def resident_from_flat(flat: np.ndarray, sizes: np.ndarray, device,
                       labels: Optional[np.ndarray] = None) -> ResidentClips:
    """Uploads a corpus that is already flat ((total[, D]) and per-clip
    sizes), such as the d2v wav corpus of ``WavCropDataset.load_all_audio``."""
    sizes = np.asarray(sizes, np.int64)
    total = int(sizes.sum())
    if total >= 2**31:
        raise ValueError(f"corpus too large for int32 addressing ({total} rows)")
    if total != len(flat):
        raise ValueError(f"flat length {len(flat)} != sizes sum {total}")
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    if labels is None:
        labels = np.full(len(sizes), -1, np.int32)
    dev_flat = torch.from_numpy(np.ascontiguousarray(flat)).to(device)
    res = ResidentClips(flat=dev_flat, offsets=torch.from_numpy(offsets).to(device),
                        sizes=torch.from_numpy(sizes).to(device),
                        labels=torch.from_numpy(np.asarray(labels, np.int32)).to(device))
    logger.info("resident corpus: %d clips, %.1f MB %s committed to %s", len(sizes),
                dev_flat.nbytes / 1e6, dev_flat.dtype, device)
    return res


def resident_nbytes(store, dtype: DType = None) -> int:
    """The upload's size, estimated without building anything."""
    flat = store_flat(store)
    itemsize = _torch_dtype(dtype).itemsize if dtype is not None else flat.itemsize
    width = 1 if flat.ndim == 1 else flat.shape[1]
    return int(np.asarray(store.sizes, np.int64).sum()) * width * itemsize


def gather_clips(c: ResidentClips, idx: torch.Tensor, t: int,
                 frame_cap: Optional[int] = None,
                 starts: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The padded (B, t[, D]) batch of clips ``idx`` ((B,) int, -1 = padded
    row) and its mask (True = pad): clips truncated to ``t`` (and
    ``frame_cap``), zero fill; the row assembly of PaddedBatchIterator and
    PaddedWavIterator, on the device.

    ``starts`` ((B,) int): a read offset within each clip, the fixed-size
    random crop of ``WavCropDataset.batches``: row b reads samples
    [starts[b], starts[b] + t) of clip idx[b], zero-padded past its end."""
    safe = idx.clamp(min=0).long()
    off, sz = c.offsets[safe], c.sizes[safe]
    if starts is not None:
        off = off + starts.long()
        sz = sz - starts.long()  # samples left from the crop start
    pos_t = torch.arange(t, device=idx.device)
    valid = (pos_t[None, :] < sz[:, None]) & (idx >= 0)[:, None]
    if frame_cap is not None and t > frame_cap:
        valid = valid & (pos_t[None, :] < frame_cap)
    if c.flat.shape[0] == 0:
        return c.flat.new_zeros((idx.shape[0], t) + tuple(c.flat.shape[1:])), ~valid
    pos = off[:, None] + torch.minimum(pos_t[None, :], (sz[:, None] - 1).clamp(min=0))
    out = c.flat[pos]
    vmask = valid if out.ndim == 2 else valid[..., None]
    return torch.where(vmask, out, torch.zeros((), dtype=out.dtype, device=out.device)), ~valid


def index_batches(it, epoch: int) -> Iterator[Tuple[np.ndarray, int]]:
    """The index-only projection of a PaddedBatchIterator /
    PaddedWavIterator epoch: (padded_idx (B,) int32 with -1 on pad rows,
    bucket length T) for exactly the batches the iterator assembles (the
    same (seed, epoch) order, bucket snap and frame cap)."""
    it.set_epoch(epoch)
    sizes = np.asarray(it.store.sizes)
    max_frames = getattr(it, "max_frames", None)
    order = epoch_order(
        len(sizes),
        shuffle=it.shuffle,
        seed=it.seed,
        epoch=it.epoch,
        bucket_shuffle=getattr(it, "bucket_shuffle", False),
        sizes=sizes,
        buckets=it.buckets,
        batch_size=it.batch_size,
        max_frames=max_frames,
    )
    B = it.batch_size
    for start in range(0, len(order), B):
        idx = order[start : start + B]
        t_max = int(sizes[idx].max()) if len(idx) else 1
        if max_frames is not None:
            t_max = min(t_max, max_frames)
        padded = np.full(B, -1, np.int32)
        padded[: len(idx)] = idx
        yield padded, pad_to_bucket(t_max, it.buckets)


def paired_index_epoch(clean_it, noisy_it, epoch: int):
    """Index-only ``paired_epoch``: the two streams of one epoch, zipped
    and cut to the shorter (reference train.py:479-483)."""
    n = min(len(clean_it), len(noisy_it))
    ci, ni = index_batches(clean_it, epoch), index_batches(noisy_it, epoch)
    for _ in range(n):
        yield next(ci), next(ni)


def upload_index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """One small host-to-device copy of a step's (or a chunk's) indices."""
    src = torch.from_numpy(idx)
    if device.type == "cuda":
        src = src.pin_memory()
    return src.to(device, non_blocking=True)


def gather_feature_batch(c: ResidentClips, idx: torch.Tensor, t: int,
                         frame_cap: Optional[int] = None) -> Batch:
    """A feature ``Batch`` assembled on the device, bit-equal to the host
    rows of PaddedBatchIterator for the same indices."""
    feats, pad = gather_clips(c, idx, t, frame_cap)
    labels = torch.where(idx >= 0, c.labels[idx.clamp(min=0).long()], -1).to(torch.int32)
    return Batch(feats=feats.float(), padding_mask=pad, labels=labels, ids=idx,
                 row_valid=idx >= 0)


def materialize_metrics(per_step: List[Dict[str, torch.Tensor]], keys) -> np.ndarray:
    """One device-to-host copy for an epoch's per-step metric scalars:
    (S, K) float32, in step order."""
    if not per_step:
        return np.zeros((0, len(keys)), np.float32)
    return torch.stack([torch.stack([m[k].float() for k in keys]) for m in per_step]
                       ).cpu().numpy()


def materialize_tracking(per_step: List[Dict[str, torch.Tensor]]) -> List[Dict[str, np.ndarray]]:
    """One device-to-host copy per tracking key (not per step); the host
    dicts come back in step order."""
    if not per_step:
        return []
    keys = list(per_step[0])
    host = {k: torch.stack([t[k] for t in per_step]).cpu().numpy() for k in keys}
    return [{k: host[k][i] for k in keys} for i in range(len(per_step))]


def materialize_chunked_metrics(per_chunk: List[Dict[str, torch.Tensor]], keys) -> np.ndarray:
    """materialize_metrics for chunks whose metrics are stacked (S_chunk,):
    (S_total, K) float32 in step order, one copy."""
    if not per_chunk:
        return np.zeros((0, len(keys)), np.float32)
    return torch.stack([torch.cat([m[k].float().reshape(-1) for m in per_chunk]) for k in keys],
                       dim=1).cpu().numpy()


def make_resident_dad_step(head, tx, cfg):
    """The feature DAD step behind a gather from the resident corpora:

    step(state, clean_c, noisy_c, clean_idx, noisy_idx, scalars, anchors,
         generator=None, draws=None, *, t_clean, t_noisy, frame_cap=None)
    -> (state', metrics, tracking)

    Each batch is gathered at its own bucket, so the step sees the
    streamed step's batches. ``draws(noisy_batch)`` gives the step's
    weak/strong draws at that batch's shape (None: the step's generator)."""
    core = make_dad_train_step(head, tx, cfg)

    def step(state, clean_c: ResidentClips, noisy_c: ResidentClips, clean_idx, noisy_idx,
             scalars, anchors, generator=None,
             draws: Optional[Callable[[Batch], Optional[StepDraws]]] = None,
             *, t_clean: int, t_noisy: int, frame_cap: Optional[int] = None):
        clean = gather_feature_batch(clean_c, clean_idx, t_clean, frame_cap)
        noisy = gather_feature_batch(noisy_c, noisy_idx, t_noisy, frame_cap)
        return core(state, clean, noisy, scalars, anchors, generator,
                    None if draws is None else draws(noisy))

    return step


def make_resident_dad_epoch_runner(head, tx, cfg):
    """A chunk of feature DAD steps over the resident corpora, the
    counterpart of ``dad/epoch_scan.make_dad_epoch_runner``:

    run(state, clean_c, noisy_c, clean_idx (S, B), noisy_idx (S, B),
        scalars, anchors, generator=None, draws=None, *, t_pad,
        frame_cap=None) -> (state', metrics_mean, tracking_stacked)

    Both streams pad to the chunk-common ``t_pad``, as a streamed chunk
    does. ``draws(s, noisy_batch)`` gives step s's draws at the batch's
    own frame count; they are zero-padded to ``t_pad``."""
    core = make_dad_train_step(head, tx, cfg)

    def run(state, clean_c: ResidentClips, noisy_c: ResidentClips, clean_idx, noisy_idx,
            scalars, anchors, generator=None,
            draws: Optional[Callable[[int, Batch], Optional[StepDraws]]] = None,
            *, t_pad: int, frame_cap: Optional[int] = None):
        metrics, tracking = [], []
        for s in range(clean_idx.shape[0]):
            clean = gather_feature_batch(clean_c, clean_idx[s], t_pad, frame_cap)
            noisy = gather_feature_batch(noisy_c, noisy_idx[s], t_pad, frame_cap)
            d = None if draws is None else draws(s, noisy)
            state, m, tr = core(state, clean, noisy, scalars, anchors, generator,
                                None if d is None else pad_draws(d, t_pad))
            metrics.append(m)
            tracking.append(tr)
        mean = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
        stacked = {k: torch.stack([t[k] for t in tracking]) for k in tracking[0]}
        return state, mean, stacked

    return run


def _gather_fused_pair(clean_c: ResidentClips, wav_c: ResidentClips, clean_idx, noisy_idx,
                       t_clean: int, t_wav: int, frame_cap: Optional[int]):
    """One fused (clean features, noisy wavs) batch pair gathered from the
    resident corpora: the prologue of the resident fused step and runner."""
    c = gather_feature_batch(clean_c, clean_idx, t_clean, frame_cap)
    wav, wmask = gather_clips(wav_c, noisy_idx, t_wav)
    clean = CleanFeatureBatch(feats=c.feats, frame_mask=c.padding_mask, labels=c.labels,
                              row_valid=c.row_valid)
    noisy = FusedBatch(wav=wav.float(), wav_mask=wmask, labels=torch.full_like(noisy_idx, -1),
                       row_valid=noisy_idx >= 0, ids=noisy_idx)
    return clean, noisy


def _check_cached(cfg: FusedConfig) -> None:
    if not cfg.cache_clean_features:
        raise ValueError("resident mode requires cache_clean_features "
                         "(the fused trainer's configuration)")


def make_resident_fused_step(encoder, head, tx, cfg: FusedConfig, mesh=None):
    """The fused cached-clean step behind a gather from the resident
    corpora:

    step(state, clean_c, wav_c, clean_idx, noisy_idx, scalars, anchors,
         generator=None, noise_bank=None, draws=None, *, t_clean, t_wav,
         frame_cap=None) -> (state', metrics)

    The encoder module holds its weights, so the JAX step's ``enc_params``
    has no counterpart here. With a mesh, the step is the fused mesh step
    on the gathered global batch pair."""
    _check_cached(cfg)
    core = make_fused_extract_train_step(encoder, head, tx, cfg, mesh)

    def step(state, clean_c: ResidentClips, wav_c: ResidentClips, clean_idx, noisy_idx,
             scalars, anchors, generator=None, noise_bank=None,
             draws: Optional[StepDraws] = None,
             *, t_clean: int, t_wav: int, frame_cap: Optional[int] = None):
        clean, noisy = _gather_fused_pair(clean_c, wav_c, clean_idx, noisy_idx,
                                          t_clean, t_wav, frame_cap)
        return core(state, clean, noisy, scalars, anchors, generator, noise_bank, draws)

    return step


def make_resident_fused_epoch_runner(encoder, head, tx, cfg: FusedConfig, mesh=None):
    """A chunk of fused steps over the resident corpora:

    run(state, clean_c, wav_c, clean_idx (S, B), noisy_idx (S, B), scalars,
        anchors, generator=None, noise_bank=None, draws=None, *, t_clean,
        t_wav, frame_cap=None) -> (state', metrics_stacked)

    Every step of the chunk pads to the chunk-common (t_clean, t_wav);
    ``draws(s)`` gives step s's draws (None: the generator). Metrics come
    back stacked (S, ...), tracking included."""
    step = make_resident_fused_step(encoder, head, tx, cfg, mesh)

    def run(state, clean_c: ResidentClips, wav_c: ResidentClips, clean_idx, noisy_idx,
            scalars, anchors, generator=None, noise_bank=None,
            draws: Optional[Callable[[int], Optional[StepDraws]]] = None,
            *, t_clean: int, t_wav: int, frame_cap: Optional[int] = None):
        per_step = []
        for s in range(clean_idx.shape[0]):
            state, m = step(state, clean_c, wav_c, clean_idx[s], noisy_idx[s], scalars, anchors,
                            generator, noise_bank, None if draws is None else draws(s),
                            t_clean=t_clean, t_wav=t_wav, frame_cap=frame_cap)
            per_step.append(m)
        stacked = {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]
                   if k != "tracking"}
        if "tracking" in per_step[0]:
            stacked["tracking"] = {k: torch.stack([m["tracking"][k] for m in per_step])
                                   for k in per_step[0]["tracking"]}
        return state, stacked

    return run


def make_resident_d2v_step(model, tx):
    """The d2v train step behind a crop gather from the resident wav corpus:

    step(state, corpus, idx, starts, generator=None, draws=None, *, crop)
    -> (state', metrics)

    ``idx`` / ``starts`` are (B,) int32 (flat clip index, crop offset).
    The corpus holds the normalised clips, so the gathered batch equals the
    streamed ``WavCropDataset.batches`` batch for the same indices."""
    from ..models.d2v_pretrain import make_d2v_train_step

    core = make_d2v_train_step(model, tx)

    def step(state, corpus: ResidentClips, idx, starts, generator=None, draws=None, *,
             crop: int):
        wav, pad = gather_clips(corpus, idx, crop, starts=starts)
        return core(state, wav.float(), pad, generator, draws)

    return step
