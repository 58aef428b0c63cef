from .runner import (
    run_single_experiment,
    run_single_fused_experiment,
    scrape_best_results,
)
from .ablation import (
    GRANULAR_ABLATIONS,
    STANDARD_ABLATIONS,
    fused_noise_condition_experiments,
    noise_condition_experiments,
    run_ablation_suite,
    run_experiment_on_multiple_noises,
    run_fused_ablation_suite,
    run_fused_experiment_on_multiple_noises,
    parse_injection_cells,
    run_fused_multi_noise_suite,
    run_multi_noise_suite,
)
from .sensitivity import run_fused_sensitivity_sweep, run_sensitivity_sweep
from .preprocess import run_noise_grid, write_noisy_manifest

__all__ = [
    "run_single_experiment",
    "run_single_fused_experiment",
    "scrape_best_results",
    "STANDARD_ABLATIONS",
    "GRANULAR_ABLATIONS",
    "noise_condition_experiments",
    "fused_noise_condition_experiments",
    "run_ablation_suite",
    "run_fused_ablation_suite",
    "run_experiment_on_multiple_noises",
    "run_fused_experiment_on_multiple_noises",
    "parse_injection_cells",
    "run_multi_noise_suite",
    "run_fused_multi_noise_suite",
    "run_sensitivity_sweep",
    "run_fused_sensitivity_sweep",
    "run_noise_grid",
    "write_noisy_manifest",
]
