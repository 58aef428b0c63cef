"""Traffic and corpora made from the seed.

Every seed gets the same multiset of clip lengths and of arrival gaps (the
quantiles of their distributions), in an order drawn from the seed, so
that two seeds ask the same work and differ only in its order and in the
audio. Copies of ``chip_smoke.py``'s distributions: clip lengths
lognormal with mean 4.5 s and sigma 0.6, clipped to 0.6-30 s (IEMOCAP's
range)."""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, Iterator, Tuple

import numpy as np

SAMPLE_RATE = 16000
BASE_SECONDS = 40  # the audio every served clip is cut from


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator keyed by the run's seed (any integer) and tags."""
    return np.random.default_rng([int(seed) % (1 << 64), *tags])


def torch_seed(seed: int, tag: int = 0) -> int:
    """A torch generator seed from the run's seed and a tag."""
    return (int(seed) * 1000003 + tag) % (1 << 63)


def lognormal_quantiles(n: int, mean: float, sigma: float, lo: float, hi: float) -> np.ndarray:
    """The n quantiles (k + 0.5) / n of a lognormal with mean ``mean``,
    clipped to [lo, hi], ascending."""
    mu = math.log(mean) - sigma * sigma / 2
    nd = NormalDist()
    z = np.array([nd.inv_cdf((k + 0.5) / n) for k in range(n)])
    return np.clip(np.exp(mu + sigma * z), lo, hi)


def lognormal_lengths(n: int, mean_s: float, sigma: float, lo_s: float, hi_s: float) -> np.ndarray:
    """``lognormal_quantiles`` of clip lengths in seconds, in samples."""
    return (lognormal_quantiles(n, mean_s, sigma, lo_s, hi_s) * SAMPLE_RATE).astype(np.int64)


def serve_schedule(seed: int, rate: float, seconds: float, lengths: Dict) -> Dict[str, np.ndarray]:
    """Open-loop Poisson arrivals at ``rate`` over ``seconds``: the
    n = rate x seconds quantiles of the exponential gap, and n clip
    lengths, each permuted by the seed; each clip's offset into the
    seed's audio."""
    n = max(1, int(round(rate * seconds)))
    rng = rng_for(seed, 1)
    lens = rng.permutation(lognormal_lengths(n, lengths["mean_s"], lengths["sigma"],
                                             lengths["min_s"], lengths["max_s"]))
    gaps = rng.permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    arrivals = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    offsets = rng.integers(0, BASE_SECONDS * SAMPLE_RATE - lens + 1)
    return dict(arrivals=arrivals, lengths=lens, offsets=offsets)


def serve_audio(seed: int) -> np.ndarray:
    """BASE_SECONDS of int16 PCM: a voiced-like tone with a wandering
    pitch, vibrato, harmonics, a syllable envelope and noise."""
    rng = rng_for(seed, 2)
    n = BASE_SECONDS * SAMPLE_RATE
    t = np.arange(n) / SAMPLE_RATE
    f0 = 150 + 50 * np.sin(2 * np.pi * 0.23 * t + rng.uniform(0, 6.3)) \
        + 10 * np.sin(2 * np.pi * 5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.1 * t + rng.uniform(0, 6.3))
    x = env * (0.30 * np.sin(phase) + 0.12 * np.sin(2 * phase) + 0.05 * np.sin(3 * phase))
    x += 0.03 * rng.standard_normal(n)
    return np.clip(np.rint(x * 32767.0), -32768, 32767).astype(np.int16)


def d2v_lengths(seed: int, corpus: Dict) -> np.ndarray:
    """The pretraining corpus's clip lengths in samples, permuted by the
    seed: ``corpus["clips"]`` lognormal quantiles, keeping those of
    ``corpus["min_samples"]`` or more (as the d2v dataset keeps them)."""
    lens = lognormal_lengths(corpus["clips"], corpus["mean_s"], corpus["sigma"],
                             corpus["min_s"], corpus["max_s"])
    lens = lens[lens >= corpus["min_samples"]]
    return rng_for(seed, 3).permutation(lens)


def crop_batches(seed: int, sizes: np.ndarray, batch: int, crop: int,
                 align: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless (idx (B,) int32, starts (B,) int32): each epoch a seeded
    permutation of the clips in batches (the last partial batch dropped),
    each clip cropped at a uniform start floored to ``align`` where it is
    longer than ``crop`` (``WavCropDataset``'s draw)."""
    epoch = 0
    while True:
        order = rng_for(seed, 4, epoch).permutation(len(sizes))
        for b in range(len(sizes) // batch):
            rows = order[b * batch:(b + 1) * batch]
            rng = rng_for(seed, 5, epoch, b)
            idx = rows.astype(np.int32)
            starts = np.zeros(batch, np.int32)
            for r, i in enumerate(rows):
                n = int(sizes[i])
                if n > crop:
                    s = int(rng.integers(0, n - crop + 1))
                    starts[r] = s - s % align
            yield idx, starts
        epoch += 1


def feature_clips(seed: int, corpus: Dict) -> Dict[str, np.ndarray]:
    """An IEMOCAP-sized feature corpus's clips (``chip_smoke.py``'s
    distributions): ``corpus["classes"]`` clips of each class, frame counts
    the lognormal quantiles (median ``frames``, ``sigma``, clipped to
    ``min``-``max``), labels and lengths each permuted by the seed, clip i
    in session i % ``sessions`` + 1."""
    counts = list(corpus["classes"].values())
    n = sum(counts)
    mean = corpus["frames"] * math.exp(corpus["sigma"] ** 2 / 2)  # of a lognormal with that median
    sizes = lognormal_quantiles(n, mean, corpus["sigma"], corpus["min"], corpus["max"])
    rng = rng_for(seed, 7)
    labels = rng.permutation(np.repeat(np.arange(len(counts)), counts)).astype(np.int64)
    sizes = rng.permutation(sizes.astype(np.int64))
    groups = np.arange(n) % corpus["sessions"] + 1
    return dict(sizes=sizes, labels=labels, groups=groups)


def feature_corpus(seed: int, corpus: Dict, clips: Dict[str, np.ndarray], dev,
                   chunk: int = 1 << 16) -> Tuple[np.ndarray, np.ndarray]:
    """(clean, noisy) features, (total frames, dim) float32 on the host:
    clean = N(0, 1) + the clip's class mean (class means N(0,
    ``class_mean_std``^2)), noisy = clean + ``noise_std`` x N(0, 1), drawn
    on the device in chunks of rows and copied to the host."""
    import torch

    dim, sizes = corpus["dim"], clips["sizes"]
    gen = torch.Generator(device=dev).manual_seed(torch_seed(seed, 8))
    means = torch.randn((len(corpus["classes"]), dim), generator=gen, device=dev) \
        * corpus["class_mean_std"]
    rows = torch.from_numpy(np.repeat(clips["labels"], sizes)).to(dev)
    total = int(sizes.sum())
    clean = np.empty((total, dim), np.float32)
    noisy = np.empty((total, dim), np.float32)
    for a in range(0, total, chunk):
        b = min(total, a + chunk)
        c = torch.randn((b - a, dim), generator=gen, device=dev) + means[rows[a:b]]
        nz = c + corpus["noise_std"] * torch.randn((b - a, dim), generator=gen, device=dev)
        clean[a:b] = c.cpu().numpy()
        noisy[a:b] = nz.cpu().numpy()
    return clean, noisy
