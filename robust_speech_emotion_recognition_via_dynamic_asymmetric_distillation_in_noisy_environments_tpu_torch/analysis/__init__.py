from .disagreement import analyze_disagreement
from .confirmation_bias import analyze_confirmation_bias
from .dacp_evolution import analyze_dacp_evolution
from .tsne import analyze_tsne
from .distribution import analyze_distribution

__all__ = [
    "analyze_disagreement",
    "analyze_confirmation_bias",
    "analyze_dacp_evolution",
    "analyze_tsne",
    "analyze_distribution",
]
