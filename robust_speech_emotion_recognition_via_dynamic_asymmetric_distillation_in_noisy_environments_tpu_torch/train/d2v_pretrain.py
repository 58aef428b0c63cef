"""The d2v self-supervised pretraining loop: the counterpart of the JAX
package's ``train/d2v_pretrain.py``.

Dataset: manifest-driven raw wavs with fixed-size random crops, several
manifests mixed by per-corpus sampling weights; short clips are padded and
masked. Epoch composition, shuffles and crop draws are numpy streams keyed
as the JAX package keys them, so the batches are bit-equal to its own. The
loop runs the d2v step (``models/d2v_pretrain.py``) on one device, reads
each step's collapse telemetry while the next step runs, validates every
``valid_every`` steps, checkpoints the whole state and exports the encoder.

Files in ``save_dir`` (the JAX package's names, ``.pt`` where it writes
flax ``.msgpack``): ``d2v_last_state.pt`` (+ ``.meta.json``),
``d2v_best_state.pt`` (+ ``.meta.json``), ``encoder_params.pt``,
``encoder_params_best.pt`` (state dicts of ``Emotion2vecEncoder``) and
``d2v_training_history.json``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..audio.wavio import read_mono
from ..configs import D2vPretrainConfig, EncoderConfig
from ..data.manifests import read_manifest
from ..data.prefetch import prefetch
from ..utils import MESH_NOT_PORTED, dump_json, get_logger, resolve_device
from .checkpointing import restore_train_state, save_train_state

logger = get_logger(__name__)


def _normalize_clip(wav: np.ndarray) -> np.ndarray:
    """Whole-clip layer norm (the extraction CLI's preprocessing)."""
    mu = wav.mean()
    var = wav.var()
    return (wav - mu) / np.sqrt(var + 1e-5)


class WavCropDataset:
    """Random fixed-size crops over one or more wav manifests.

    ``weights`` scale how much of each corpus an epoch sees: the integer
    part repeats the corpus whole, the fractional part adds a seeded
    per-epoch subset of that fraction of its clips. Clips whose manifest
    frames are under ``min_sample_size`` are left out (frames < 0: kept)."""

    def __init__(self, manifest_dirs: Sequence[str], pcfg: D2vPretrainConfig,
                 split: str = "train", weights: Optional[Sequence[float]] = None):
        self.pcfg = pcfg
        self.base_lists: List[List[Tuple[str, int]]] = []
        for d in manifest_dirs:
            root, files = read_manifest(d, split)
            kept = [(os.path.join(root, rel), frames) for rel, frames in files
                    if frames < 0 or frames >= pcfg.min_sample_size]
            if len(files) > len(kept):
                logger.info("%s: skipped %d clips under min_sample_size=%d",
                            d, len(files) - len(kept), pcfg.min_sample_size)
            self.base_lists.append(kept)
        self._init_weights(weights)

    def _init_weights(self, weights: Optional[Sequence[float]]) -> None:
        if weights is None:
            weights = [1.0] * len(self.base_lists)
        if any(w <= 0 for w in weights):
            raise ValueError(f"sampling weights must be positive: {weights}")
        self.weights = [float(w) for w in weights]
        # the flat clip index space (the resident corpus addresses clips by it)
        self._flat_entries = [e for lst in self.base_lists for e in lst]
        self._corpus_starts = np.concatenate(
            [[0], np.cumsum([len(lst) for lst in self.base_lists])]).astype(np.int64)
        if not self.files_for_epoch(0):
            raise ValueError("no usable clips in the given manifests")

    def _load_audio(self, entry) -> np.ndarray:
        """A manifest entry -> mono float32 (``data/binarized.py`` reads a
        packed store instead)."""
        path, _frames = entry
        return read_mono(path, self.pcfg.sample_rate)

    def indices_for_epoch(self, epoch: int) -> np.ndarray:
        """The epoch's clips as flat indices, shared by ``batches`` and
        ``index_crop_batches``."""
        out: List[int] = []
        for ci, (lst, w) in enumerate(zip(self.base_lists, self.weights)):
            base = int(self._corpus_starts[ci])
            reps, frac = int(w), w - int(w)
            for _ in range(reps):
                out.extend(range(base, base + len(lst)))
            n_frac = int(round(frac * len(lst)))
            if n_frac:
                rng = np.random.default_rng((self.pcfg.random_seed, epoch, ci))
                pick = rng.choice(len(lst), n_frac, replace=False)
                out.extend(base + int(i) for i in pick)
        return np.asarray(out, np.int64)

    def files_for_epoch(self, epoch: int) -> list:
        return [self._flat_entries[int(g)] for g in self.indices_for_epoch(epoch)]

    def load_all_audio(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every distinct clip decoded once and normalised as ``batches``
        normalises it, in one flat float32 array: (flat, sizes) in flat-index
        order (the host side of the resident corpus)."""
        sizes = np.empty(len(self._flat_entries), np.int64)
        clips: List[np.ndarray] = []
        for gi, entry in enumerate(self._flat_entries):
            audio = np.asarray(self._load_audio(entry), np.float32)
            if self.pcfg.normalize:
                audio = _normalize_clip(audio)
            sizes[gi] = len(audio)
            clips.append(audio)
        flat = np.concatenate(clips) if clips else np.zeros(0, np.float32)
        return flat, sizes

    def estimated_audio_nbytes(self) -> int:
        """The resident corpus's f32 size from the manifest frames column,
        without decoding (unknown frames count as one crop)."""
        total = sum(int(f) if f >= 0 else self.pcfg.crop_size for _k, f in self._flat_entries)
        return total * 4

    def __len__(self) -> int:
        return len(self.files_for_epoch(0))

    def num_batches(self, batch_size: int, epoch: int = 0) -> int:
        return len(self.files_for_epoch(epoch)) // batch_size  # drop_last

    def batches(self, epoch: int, batch_size: int, skip: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (wav (B, crop) f32, padding_mask (B, crop) bool). ``skip``
        drops the first batches without reading them (mid-epoch resume)."""
        pcfg = self.pcfg
        crop = pcfg.crop_size
        files = self.files_for_epoch(epoch)
        order = np.random.default_rng((pcfg.random_seed, epoch)).permutation(len(files))
        n_use = self.num_batches(batch_size, epoch) * batch_size
        for start in range(skip * batch_size, n_use, batch_size):
            idx = order[start : start + batch_size]
            # crop draws keyed by (seed, epoch, batch): a resumed epoch
            # replays the batches the uninterrupted run would have made
            rng = np.random.default_rng((pcfg.random_seed, epoch, start // batch_size))
            wav = np.zeros((batch_size, crop), np.float32)
            pad = np.ones((batch_size, crop), bool)
            for row, i in enumerate(idx):
                audio = self._load_audio(files[int(i)])
                if pcfg.normalize:  # the whole clip, then the crop
                    audio = _normalize_clip(audio)
                n = len(audio)
                if n > crop:
                    s = int(rng.integers(0, n - crop + 1))
                    s -= s % pcfg.crop_align
                    clip = audio[s : s + crop]
                    n = crop
                else:
                    clip = audio
                wav[row, :n] = clip
                pad[row, :n] = False
            yield wav, pad


def index_crop_batches(ds: WavCropDataset, epoch: int, batch_size: int, sizes: np.ndarray,
                       skip: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The index-only projection of ``ds.batches``: (idx (B,) int32 flat
    clip indices, starts (B,) int32 crop offsets) for the same batches, the
    crop rng drawn for the same rows in the same order. ``sizes``: the true
    per-clip sample counts (``load_all_audio``)."""
    pcfg = ds.pcfg
    crop = pcfg.crop_size
    gidx = ds.indices_for_epoch(epoch)
    order = np.random.default_rng((pcfg.random_seed, epoch)).permutation(len(gidx))
    n_use = (len(gidx) // batch_size) * batch_size
    for start in range(skip * batch_size, n_use, batch_size):
        rows = order[start : start + batch_size]
        rng = np.random.default_rng((pcfg.random_seed, epoch, start // batch_size))
        idx = np.empty(batch_size, np.int32)
        starts = np.zeros(batch_size, np.int32)
        for row, i in enumerate(rows):
            g = int(gidx[int(i)])
            idx[row] = g
            n = int(sizes[g])
            if n > crop:
                s = int(rng.integers(0, n - crop + 1))
                starts[row] = s - s % pcfg.crop_align
        yield idx, starts


def _chunked(batches, chunk: int, budget: int):
    """Stacks up to ``chunk`` consecutive batches to (k, B, T), never more
    than ``budget`` steps in all."""
    buf, used = [], 0
    for wav, pad in batches:
        buf.append((wav, pad))
        if len(buf) == chunk or used + len(buf) >= budget:
            yield np.stack([w for w, _ in buf]), np.stack([p for _, p in buf])
            used += len(buf)
            buf = []
            if used >= budget:
                return
    if buf:
        yield np.stack([w for w, _ in buf]), np.stack([p for _, p in buf])


def _dataset(dirs, pcfg, binarized: bool, **kw) -> WavCropDataset:
    if binarized:
        from ..data.binarized import BinarizedWavDataset

        return BinarizedWavDataset(dirs, pcfg, **kw)
    return WavCropDataset(dirs, pcfg, **kw)


def stage_metrics(mstack: Dict[str, torch.Tensor]):
    """A step's metrics copied to the host behind it on the stream: CUDA
    tensors go ``non_blocking`` into pinned buffers, followed by an event,
    so that reading them later waits for this step alone, not for the steps
    queued after it. Returns (host tensors, event or None); the buffers
    are held with the event until it has passed. CPU tensors are taken as
    they are."""
    if not any(v.is_cuda for v in mstack.values()):
        return mstack, None
    host = {}
    for k, v in mstack.items():
        buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        buf.copy_(v, non_blocking=True)
        host[k] = buf
    event = torch.cuda.Event()
    event.record()
    return host, event


def run_d2v_pretrain(
    cfg: EncoderConfig,
    pcfg: D2vPretrainConfig,
    manifest_dirs: Sequence[str],
    save_dir: str,
    weights: Optional[Sequence[float]] = None,
    init_checkpoint: Optional[str] = None,
    log_every: int = 50,
    checkpoint_every: int = 1000,
    resume: bool = False,
    mesh=None,
    binarized: bool = False,
    transfer_dtype: Optional[str] = None,
    scan_chunk: int = 1,
    valid_manifests: Optional[Sequence[str]] = None,
    valid_split: str = "valid",
    valid_every: int = 1000,
    resident="off",
    resident_max_bytes: int = 8 << 30,
    device="cuda",
    init_state=None,
    step_draws: Optional[Callable] = None,
    valid_draws: Optional[Callable] = None,
) -> Dict:
    """Runs ``pcfg.max_steps`` updates on ``device``; returns the last
    logged metrics.

    ``init_checkpoint``: an ``emotion2vec_base.pt`` whose encoder replaces
    the fresh one (the decoder stays fresh). ``transfer_dtype`` (e.g.
    "bfloat16"): wav batches cross to the device in that dtype (quantises
    the waveform; inert when resident). ``scan_chunk``: updates per chunk
    of stacked batches (the same history as per-step). ``valid_manifests``:
    every ``valid_every`` steps and at the end, the masked objective over
    ``<dir>/<valid_split>.tsv`` with dropout off and a fixed generator; the
    best state is kept and its encoder exported. ``resident``: True / False
    / "auto": the normalised training audio on the device once, each step's
    crops gathered there from (clip, start) index vectors (bit-equal
    batches); "auto" engages under ``resident_max_bytes``; per-step only
    (True with ``scan_chunk`` > 1 raises, "auto" streams).

    Test hooks: ``init_state`` (a ``D2vTrainState`` to start from),
    ``step_draws(step)`` / ``valid_draws(batch)`` (``D2vDraws`` for the
    update from ``step`` / the validation batch, None: the generator)."""
    from ..models import d2v_pretrain as d2v_models
    from ..models.d2v_pretrain import encoder_params, init_d2v_state, init_ema_blocks

    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    device = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    model, tx, state = init_d2v_state(
        cfg, pcfg, torch.Generator(device).manual_seed(pcfg.random_seed), device)
    if init_state is not None:
        state = to_device(init_state, device)
    if init_checkpoint:
        from ..models.convert import load_emotion2vec_checkpoint

        enc = load_emotion2vec_checkpoint(init_checkpoint, cfg)
        params = {**state.params, **{k: v.to(device) for k, v in enc.items()}}
        state = state._replace(params=params, ema_blocks=init_ema_blocks(params, cfg, pcfg))
        logger.info("initialized encoder from %s", init_checkpoint)

    chunk = max(1, scan_chunk)
    if chunk > 1:
        chunk_runner = d2v_models.make_d2v_chunk_runner(model, tx)
    else:
        # through the module, so that tests and probes can wrap the factory
        step_fn = d2v_models.make_d2v_train_step(model, tx)
    ds = _dataset(manifest_dirs, pcfg, binarized, weights=weights)
    logger.info("d2v pretrain: %d clips, %d steps/epoch, %d total steps on %s",
                len(ds), ds.num_batches(pcfg.batch_size), pcfg.max_steps, device)

    use_resident = resident not in (False, "off", None)
    if use_resident and chunk > 1:
        if resident is True:
            raise ValueError("resident mode is per-step only: pass scan_chunk<=1")
        logger.info("resident auto disabled: scan_chunk=%d requested", chunk)
        use_resident = False
    if use_resident and resident == "auto" and ds.estimated_audio_nbytes() > resident_max_bytes:
        logger.info("resident corpus disabled: estimated %.1f GB > budget %.1f GB",
                    ds.estimated_audio_nbytes() / 1e9, resident_max_bytes / 1e9)
        use_resident = False
    if use_resident:
        from ..parallel import resident as resident_mod

        flat, res_sizes = ds.load_all_audio()
        if resident == "auto" and (flat.nbytes > resident_max_bytes or len(flat) >= 2**31):
            logger.info("resident corpus disabled post-decode: %.1f GB > budget "
                        "(or int32 overflow)", flat.nbytes / 1e9)
            use_resident = False
        else:
            corpus = resident_mod.resident_from_flat(flat, res_sizes, device)
            resident_step = resident_mod.make_resident_d2v_step(model, tx)
            if transfer_dtype:
                logger.info("transfer_dtype=%s inert in resident mode", transfer_dtype)
        flat = None

    rng = torch.Generator(device).manual_seed(pcfg.random_seed + 1)
    history: List[Dict] = []
    last: Dict = {}
    t0 = time.time()
    epoch = 0
    batch_in_epoch = 0
    ckpt_path = os.path.join(save_dir, "d2v_last_state.pt")
    meta: Dict = {}
    if resume and os.path.exists(ckpt_path):
        # params, optimizer and EMA from the state; generator, position and
        # history from the metadata
        state, meta = restore_train_state(ckpt_path, state)
        meta = meta or {}
        if "rng" in meta:
            rng.set_state(torch.tensor(meta["rng"], dtype=torch.uint8))
        epoch = int(meta.get("epoch", 0))
        batch_in_epoch = int(meta.get("batch_in_epoch", 0))
        history = list(meta.get("history", []))
        logger.info("resumed at step %d (epoch %d, batch %d)", int(state.step), epoch,
                    batch_in_epoch)

    best_valid = float("inf") if meta.get("best_valid") is None else float(meta["best_valid"])
    best_path = os.path.join(save_dir, "d2v_best_state.pt")

    def save_ckpt(step: int) -> None:
        save_train_state(ckpt_path, state, metadata={
            "step": step, "epoch": epoch, "batch_in_epoch": batch_in_epoch,
            "rng": rng.get_state().tolist(), "history": history,
            "best_valid": best_valid if np.isfinite(best_valid) else None,
        })

    valid_ds = None
    if valid_manifests:
        valid_ds = _dataset(valid_manifests, pcfg, binarized, split=valid_split)
        if valid_ds.num_batches(pcfg.batch_size) == 0:
            raise ValueError(
                f"valid split has {len(valid_ds)} usable clips < batch_size={pcfg.batch_size}: "
                "no validation batches (drop_last) — shrink batch_size or grow the split")
        eval_fn = d2v_models.make_d2v_eval_step(model)

    def run_validation(at_step: int) -> None:
        nonlocal best_valid
        # a fixed generator and epoch 0's crops: comparable across passes
        vgen = torch.Generator(device).manual_seed(pcfg.random_seed + 2)
        losses = []
        for i, (wav, pad) in enumerate(valid_ds.batches(0, pcfg.batch_size)):
            m = eval_fn(state.params, state.ema_blocks, torch.from_numpy(wav).to(device),
                        torch.from_numpy(pad).to(device), vgen,
                        None if valid_draws is None else valid_draws(i))
            losses.append(float(m["loss"]))
        vl = float(np.mean(losses))
        history.append({"step": at_step, "valid_loss": vl, "wall_s": round(time.time() - t0, 1)})
        improved = vl < best_valid
        logger.info("valid @ step %d | loss %.4f over %d batches%s", at_step, vl, len(losses),
                    " (best)" if improved else "")
        if improved:
            best_valid = vl
            save_train_state(best_path, state, metadata={"step": at_step, "valid_loss": vl})

    step = int(state.step)
    done = step >= pcfg.max_steps

    def process_chunk(first: int, k: int, staged) -> bool:
        """The collapse guards for every update of one dispatched chunk, and
        its history entries; True on abort. ``staged`` is ``stage_metrics``'
        (host buffers, event): only that chunk's copy is waited for."""
        nonlocal last
        host, event = staged
        if event is not None:
            event.synchronize()
        m = {kk: np.atleast_1d(v.float().numpy()) for kk, v in host.items()}
        for i in range(k):
            s = first + i
            abort = False
            if float(m["target_var"][i]) < pcfg.min_target_var:
                logger.error("target variance collapsed at step %d (%.4f < %.2f)",
                             s, float(m["target_var"][i]), pcfg.min_target_var)
                abort = True
            if float(m["pred_var"][i]) < pcfg.min_pred_var:
                logger.error("prediction variance collapsed at step %d (%.4f < %.2f)",
                             s, float(m["pred_var"][i]), pcfg.min_pred_var)
                abort = True
            # the final or aborting update is logged off the log_every grid
            if s % log_every == 0 or s == 1 or abort or s >= pcfg.max_steps:
                last = {kk: float(v[i]) for kk, v in m.items()}
                last["step"] = s
                last["wall_s"] = round(time.time() - t0, 1)
                history.append(last)
                logger.info("step %d | loss %.4f (d2v %.4f cls %.4f) | tvar %.3f pvar %.3f | "
                            "decay %.5f", s, last["loss"], last["d2v_loss"], last["cls_loss"],
                            last["target_var"], last["pred_var"], last["ema_decay"])
            if abort:
                return True
        return False

    def draws_for(first: int, k: int):
        if step_draws is None:
            return None
        return [step_draws(first - 1 + i) for i in range(k)]

    # the guards read a step's metrics while the next step runs (lag 1): a
    # collapse is detected one dispatch late, its in-flight successor is
    # dropped from the history (the saved state includes it)
    aborted = False
    pending = None  # (first step, k, metrics of that chunk)
    while not done:
        epoch_had_batches = False
        if use_resident:
            batch_iter = index_crop_batches(ds, epoch, pcfg.batch_size, res_sizes,
                                            skip=batch_in_epoch)
        else:
            src = ds.batches(epoch, pcfg.batch_size, skip=batch_in_epoch)
            if chunk > 1:
                src = _chunked(src, chunk, pcfg.max_steps - step)
            batch_iter = prefetch(src, depth=2, to_device=True,
                                  transfer_fp32_as=transfer_dtype, device=device)
        for wavs, pads in batch_iter:
            epoch_had_batches = True
            first = step + 1
            if use_resident:
                k = 1
                d = draws_for(first, 1)
                # (wavs, pads) are the (idx, starts) index vectors here
                state, mstack = resident_step(
                    state, corpus, resident_mod.upload_index(wavs, device),
                    resident_mod.upload_index(pads, device), rng,
                    None if d is None else d[0], crop=pcfg.crop_size)
            elif chunk > 1:
                k = int(wavs.shape[0])
                state, mstack = chunk_runner(state, wavs, pads, rng, draws_for(first, k))
            else:
                k = 1
                d = draws_for(first, 1)
                state, mstack = step_fn(state, wavs, pads, rng, None if d is None else d[0])
            step += k
            batch_in_epoch += k
            staged = stage_metrics(mstack)
            if pending is not None and process_chunk(*pending):
                done = aborted = True
            pending = (first, k, staged)
            at_end = step >= pcfg.max_steps
            crossed = bool(checkpoint_every) and (
                step // checkpoint_every > (first - 1) // checkpoint_every)
            vcrossed = (valid_ds is not None and valid_every > 0
                        and step // valid_every > (first - 1) // valid_every)
            if at_end or done or crossed or vcrossed:
                # drain first: history complete and ordered; after an abort
                # the in-flight chunk is discarded
                if not aborted and process_chunk(*pending):
                    done = aborted = True
                pending = None
            if vcrossed and not (at_end or done):
                run_validation(step)  # the final pass runs after the loop
            if crossed:
                save_ckpt(step)
            if at_end or done:
                done = True
                break
        else:
            if not epoch_had_batches and batch_in_epoch == 0:
                # too few clips for one batch (a resume at an exact epoch
                # boundary also gives an empty pass, and rolls on)
                raise ValueError(
                    f"epoch {epoch} produced no batches ({len(ds.files_for_epoch(epoch))} "
                    f"usable clips < batch_size={pcfg.batch_size}, drop_last) — shrink "
                    "batch_size or relax min_sample_size")
            epoch += 1
            batch_in_epoch = 0

    if valid_ds is not None and not aborted:
        # never after a collapse: a degenerate state is not crowned best
        run_validation(int(state.step))
    save_ckpt(int(state.step))
    enc_path = os.path.join(save_dir, "encoder_params.pt")
    _save_encoder(encoder_params(state.params), enc_path)
    if valid_ds is not None and os.path.exists(best_path):
        best_state, _ = restore_train_state(best_path, state)
        _save_encoder(encoder_params(best_state.params),
                      os.path.join(save_dir, "encoder_params_best.pt"))
        logger.info("best valid loss %.4f -> encoder_params_best.pt", best_valid)
    dump_json(history, os.path.join(save_dir, "d2v_training_history.json"))
    logger.info("saved %s (+ encoder %s)", ckpt_path, enc_path)
    return last


def to_device(x, device):
    """A state or draws structure (NamedTuples, tuples and dicts of tensors,
    None leaves) with its tensors on ``device``."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: v.to(device) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [to_device(v, device) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x.to(device)


def _save_encoder(params, path: str) -> None:
    torch.save({k: v.detach().cpu() for k, v in params.items()}, path)


def load_pretrained_encoder(save_dir: str, cfg: EncoderConfig, device="cuda"):
    """The exported encoder (``encoder_params.pt``) as an
    ``Emotion2vecEncoder`` on ``device``, in eval mode without gradients."""
    from ..models.emotion2vec import Emotion2vecEncoder

    dev = resolve_device(device)
    with torch.device(dev):
        enc = Emotion2vecEncoder(cfg)
    sd = torch.load(os.path.join(save_dir, "encoder_params.pt"), map_location=dev,
                    weights_only=True)
    enc.load_state_dict(sd)
    return enc.eval().requires_grad_(False)
