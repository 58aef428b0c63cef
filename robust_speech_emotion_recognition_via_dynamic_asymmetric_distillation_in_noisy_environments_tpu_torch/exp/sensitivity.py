"""Hyperparameter sensitivity sweeps (reference
run_hyperparameter_sensitivity_iemocap.py:16-268 +
plot_sensitivity_results.py:22-208).

Sweeps one knob over a value grid, records noisy WA/W-F1 per value, writes a
JSON and a WA-vs-value curve PNG (skipped without matplotlib). A failed
point is recorded as a row with an ``"error"`` and the sweep goes on; the
CLI then exits with status 1.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Sequence

from ..configs import DADConfig
from ..utils import dump_json, get_logger
from .runner import run_single_experiment

logger = get_logger(__name__)

DEFAULT_GRID = (0.0, 0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 1.0)

# knobs the reference sweeps: lambda_ECDA (WEIGHT_ECDA), DACP lambda
# (DACP_CALIBRATION_STRENGTH_LAMBDA), and the (gamma, delta) pair — the
# synthetic knob ECDA_GAMMA_DELTA sets both jointly like the reference's
# paired sweep (run_hyperparameter_sensitivity_iemocap.py)
SWEEPABLE = {
    "WEIGHT_ECDA": DEFAULT_GRID,
    "DACP_CALIBRATION_STRENGTH_LAMBDA": DEFAULT_GRID,
    "ECDA_COMPACTNESS_WEIGHT_GAMMA": DEFAULT_GRID,
    "ECDA_REPULSION_WEIGHT_DELTA": DEFAULT_GRID,
    "ECDA_GAMMA_DELTA": DEFAULT_GRID,
}

_PAIRED_KNOBS = {
    "ECDA_GAMMA_DELTA": (
        "ECDA_COMPACTNESS_WEIGHT_GAMMA",
        "ECDA_REPULSION_WEIGHT_DELTA",
    ),
}


def run_sensitivity_sweep(
    base_cfg: DADConfig,
    knob: str,
    values: Sequence[float] | None = None,
    fold: int = 0,
    output_dir: str = "sensitivity_results",
    extra_overrides: Mapping[str, Any] | None = None,
    runner=None,
    **runner_kw,
) -> List[Dict[str, Any]]:
    """``runner(name, overrides) -> result dict`` overrides the default
    feature-level experiment runner (run_fused_sensitivity_sweep passes a
    fused one); the sweep/plot/JSON contract is identical either way.
    ``runner_kw`` goes to the default runner, ``run_single_experiment``
    (stores, ``pretrain_params``, ``device``, ``trainer_kw``)."""
    values = list(values if values is not None else SWEEPABLE.get(knob, DEFAULT_GRID))
    os.makedirs(output_dir, exist_ok=True)
    if runner is None:
        def runner(name, overrides):
            return run_single_experiment(base_cfg, name, overrides, fold,
                                         **runner_kw)
    results = []
    for v in values:
        overrides = dict(extra_overrides or {})
        if knob in _PAIRED_KNOBS:
            for sub in _PAIRED_KNOBS[knob]:
                overrides[sub] = v
        else:
            overrides[knob] = v
        name = f"sens_{knob}_{v}"
        try:
            res = runner(name, overrides)
        except Exception as e:
            logger.error("sweep point %s=%s failed: %s", knob, v, e, exc_info=True)
            res = {"name": name, "error": str(e)}
        res["knob"], res["value"] = knob, v
        results.append(res)
    dump_json(results, os.path.join(output_dir, f"sensitivity_{knob}.json"))
    _plot(results, knob, output_dir)
    return results


def run_fused_sensitivity_sweep(
    base_cfg: DADConfig,
    knob: str,
    manifest_dir: str,
    encoder_cfg,
    enc_params,
    base_fused_cfg=None,
    noise_root: str | None = None,
    values: Sequence[float] | None = None,
    fold: int = 0,
    output_dir: str = "sensitivity_results",
    extra_overrides: Mapping[str, Any] | None = None,
    pretrain_params=None,
    mesh=None,
    prefetch_depth: int = 2,
    transfer_dtype: str | None = None,
    device="cuda",
    trainer_kw: Mapping[str, Any] | None = None,
) -> List[Dict[str, Any]]:
    """run_sensitivity_sweep over the FUSED wav->train mode: the
    fold-independent startup (wav decode, clean extraction, fixed noisy
    domain) is computed once and shared across every sweep point — sweep
    knobs never change the injection, so nothing is re-extracted."""
    from ..train.fused_trainer import _normalize_fused_cfg, prepare_fused_shared
    from .runner import run_single_fused_experiment

    base_fused_cfg = _normalize_fused_cfg(
        base_cfg, encoder_cfg, base_fused_cfg, noise_root
    )
    shared = prepare_fused_shared(
        base_cfg, manifest_dir, encoder_cfg, enc_params, base_fused_cfg,
        noise_root, mesh=mesh, device=device,
    )

    def runner(name, overrides):
        return run_single_fused_experiment(
            base_cfg, name, overrides, manifest_dir, encoder_cfg, enc_params,
            base_fused_cfg=base_fused_cfg, noise_root=noise_root, fold=fold,
            shared=shared, pretrain_params=pretrain_params, mesh=mesh,
            prefetch_depth=prefetch_depth, transfer_dtype=transfer_dtype,
            device=device, trainer_kw=trainer_kw,
        )

    return run_sensitivity_sweep(
        base_cfg, knob, values=values, fold=fold, output_dir=output_dir,
        extra_overrides=extra_overrides, runner=runner,
    )


def _plot(results, knob, output_dir):
    from ..analysis.common import get_pyplot

    plt = get_pyplot()
    if plt is None:
        return
    pts = [(r["value"], r["noisy_wa"]) for r in results if "noisy_wa" in r]
    if not pts:
        return
    xs, ys = zip(*pts)
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(xs, ys, marker="o")
    ax.set_xlabel(knob)
    ax.set_ylabel("noisy weighted accuracy (%)")
    ax.set_title(f"Sensitivity: {knob}")
    ax.grid(True, alpha=0.3)
    fig.savefig(os.path.join(output_dir, f"sensitivity_{knob}.png"), dpi=150,
                bbox_inches="tight")
    plt.close(fig)
