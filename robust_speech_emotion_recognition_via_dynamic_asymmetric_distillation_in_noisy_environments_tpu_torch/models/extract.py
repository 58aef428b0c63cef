"""Offline feature extraction: wav manifest -> reference-format feature
store (the counterpart of the reference's emotion2vec_speech_features.py).

Clips are length-bucketed into padded batches through the encoder; the
padding-exact batched forward (``layers.PositionalConv``) gives the same
features as per-clip extraction. ``FeatureExtractor.extract_clips`` also
serves the serving path and the fused trainer's startup. Output of
``extract_manifest``: ``<save_dir>/<split>.npy`` (float32 rows) +
``.lengths``, with the label sidecars copied through, in the JAX package's
layout byte for byte (the reference's NpyAppendArray layout).

Over a (dp, tp) mesh (``parallel/mesh.py``; ``extract --dp/--tp`` under
``torchrun``) each batch is split over dp, each rank runs its tp shard of
the encoder on its rows, and the features are gathered over dp, so every
rank returns every clip's features; only rank 0 writes the store.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs import EncoderConfig, encoder_config
from ..data.manifests import read_manifest
from ..utils import get_logger, resolve_device
from .emotion2vec import normalize_wav
from .layers import conv_out_lengths, convert_padding_mask

logger = get_logger(__name__)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; past the top, the next multiple of the top."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return int(np.ceil(n / top) * top)


class FeatureExtractor:
    """Batched emotion2vec feature extractor on one device, or over a
    mesh."""

    def __init__(
        self,
        cfg: EncoderConfig,
        state_dict: Mapping[str, torch.Tensor],
        batch_size: int = 16,
        buckets: Sequence[int] = (16000, 32000, 64000, 128000, 256000, 480000),
        device: Union[str, torch.device] = "cuda",
        mesh=None,
    ):
        """``state_dict``: the port's full encoder layout, from
        ``convert.fairseq_to_torch_encoder`` or ``flax_encoder_to_torch``.
        ``mesh`` (a ``parallel.make_mesh`` grid): batches over dp, the
        encoder over tp, on the mesh's device; ``batch_size`` must divide
        by dp."""
        from ..parallel.fused import frozen_encoder

        if mesh is not None:
            if batch_size % mesh.dp != 0:
                raise ValueError(f"batch_size={batch_size} must divide by dp={mesh.dp}")
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self.model = frozen_encoder(cfg, state_dict, self.device, mesh).eval()

    @torch.no_grad()
    def forward_batch(
        self, wav: torch.Tensor, wav_mask: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T) waveform + mask on the device -> f32 features, frame mask.
        Over a mesh: the global batch (host or device) in, this rank's rows
        through its encoder shard, the global batch's features out."""
        if self.mesh is not None:
            return self._forward_mesh(wav, wav_mask)
        x = normalize_wav(wav, wav_mask) if self.cfg.normalize_input else wav
        feats, frame_mask = self.model(x, wav_mask)
        return feats.float(), frame_mask

    def _forward_mesh(self, wav: torch.Tensor, wav_mask: torch.Tensor):
        import torch.distributed as dist

        from ..parallel.mesh import batch_sharding

        mesh = self.mesh
        w, m = batch_sharding(mesh, (wav, wav_mask))
        x = normalize_wav(w, m) if self.cfg.normalize_input else w
        feats, _ = self.model(x, m)
        parts = [torch.empty_like(feats, dtype=torch.float32) for _ in range(mesh.dp)]
        dist.all_gather(parts, feats.float().contiguous(), group=mesh.dp_group)
        feats = torch.cat(parts)
        frame_mask = convert_padding_mask(wav_mask.to(self.device), feats.shape[1],
                                          self.cfg.conv_feature_layers)
        return feats, frame_mask

    def extract_clips(self, clips: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Extracts features for a list of 1-D waveforms, preserving order."""
        order = np.argsort([len(c) for c in clips], kind="stable")
        results: List[Optional[np.ndarray]] = [None] * len(clips)
        B = self.batch_size
        for start in range(0, len(order), B):
            idx = order[start : start + B]
            group = [clips[i] for i in idx]
            T = _bucket(max(len(c) for c in group), self.buckets)
            wav = np.zeros((B, T), np.float32)
            mask = np.ones((B, T), bool)
            for row, c in enumerate(group):
                wav[row, : len(c)] = c
                mask[row, : len(c)] = False
            wav_t, mask_t = torch.from_numpy(wav), torch.from_numpy(mask)
            if self.mesh is None:  # over a mesh each rank uploads its rows only
                wav_t, mask_t = wav_t.to(self.device), mask_t.to(self.device)
            feats, _ = self.forward_batch(wav_t, mask_t)
            feats = feats.cpu().numpy()
            out_lens = conv_out_lengths(
                torch.tensor([len(c) for c in group]), self.cfg.conv_feature_layers
            ).numpy()
            for row, i in enumerate(idx):
                results[int(i)] = feats[row, : out_lens[row]]
        return results  # type: ignore[return-value]


def extract_manifest(
    manifest_dir: str,
    save_dir: str,
    cfg: EncoderConfig,
    state_dict: Mapping[str, torch.Tensor],
    split: str = "train",
    batch_size: int = 16,
    mesh=None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[int, int]:
    """Extracts every clip of ``<manifest_dir>/<split>.tsv`` and writes the
    feature store (the reference CLI's --data/--split/--save-dir); returns
    (clips, frames). Over a mesh, rank 0 writes."""
    from ..audio.wavio import read_wav

    root, files = read_manifest(manifest_dir, split)
    extractor = FeatureExtractor(cfg, state_dict, batch_size=batch_size, device=device,
                                 mesh=mesh)
    prefix = os.path.join(save_dir, split)

    clips = []
    for rel, _frames in files:
        wav, sr = read_wav(os.path.join(root, rel))
        if wav.ndim == 2:
            wav = np.mean(wav, axis=1)
        if sr != 16000:
            raise ValueError(f"expected 16 kHz, got {sr} for {rel}")
        clips.append(wav.astype(np.float32))

    feats = extractor.extract_clips(clips)
    flat = np.concatenate([f for f in feats if len(f)], axis=0)
    if mesh is not None and not mesh.is_writer:
        return len(files), len(flat)
    os.makedirs(save_dir, exist_ok=True)
    np.save(prefix + ".npy", flat)
    with open(prefix + ".lengths", "w") as f:
        for x in feats:
            print(len(x), file=f)

    # the label sidecars travel with the store, as in the reference pipeline
    for ext in (".emo", ".lbl", ".spk"):
        src = os.path.join(manifest_dir, split + ext)
        if os.path.exists(src):
            with open(src, encoding="utf-8") as fi, open(prefix + ext, "w",
                                                         encoding="utf-8") as fo:
                fo.write(fi.read())

    logger.info("extracted %d clips -> %s (%d frames)", len(files), save_dir, len(flat))
    return len(files), len(flat)


def add_extract_args(p: argparse.ArgumentParser) -> None:
    """The flags of ``extract``, shared with the package's ``cli extract``."""
    p.add_argument("--data", required=True, help="manifest dir with <split>.tsv")
    p.add_argument("--split", default="train")
    p.add_argument("--checkpoint", required=True, help="fairseq emotion2vec .pt")
    p.add_argument("--save-dir", required=True)
    p.add_argument("--layer", type=int, default=11,
                   help="kept for CLI parity; the features_only path always returns the "
                        "final (12th) block output, like the reference extraction config")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--encoder-json", default=None,
                   help="EncoderConfig overrides as inline JSON or a JSON file")
    p.add_argument("--dp", type=int, default=0,
                   help="shard batches over a dp mesh of this size (0 = single device; "
                        "under torchrun, max(dp, 1) * tp processes)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel split of the encoder (with --dp)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a GPU, cuda fails")


def run(args) -> int:
    """``extract`` from parsed flags; the encoder's config comes from
    ``configs.encoder_config`` (frozen, so the forward-only attention
    kernel serves). ``--dp``/``--tp`` need ``torchrun`` (else exit 2)."""
    from ..parallel.mesh import LaunchError, flag_mesh
    from .convert import load_emotion2vec_checkpoint

    try:
        with flag_mesh(args.dp, args.tp, args.device,
                       getattr(args, "argv", None) or ["extract"]) as mesh:
            cfg = encoder_config(args.encoder_json)
            state = load_emotion2vec_checkpoint(args.checkpoint, cfg)
            extract_manifest(args.data, args.save_dir, cfg, state, args.split,
                             args.batch_size, mesh=mesh, device=args.device)
    except LaunchError as e:
        print(f"extract: error: {e}", file=sys.stderr)
        return 2
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="extract emotion2vec features")
    add_extract_args(p)
    args = p.parse_args(argv)
    args.argv = ["extract", *(sys.argv[1:] if argv is None else argv)]
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())
