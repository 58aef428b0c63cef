from .preprocess import run_noise_grid, write_noisy_manifest

__all__ = ["run_noise_grid", "write_noisy_manifest"]
