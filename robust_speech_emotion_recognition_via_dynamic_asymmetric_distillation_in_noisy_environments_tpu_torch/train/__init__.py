from .dad_trainer import CrossDomainTrainer, extract_noise_info, run_cv

__all__ = ["CrossDomainTrainer", "extract_noise_info", "run_cv"]
