"""The PyTorch port stands alone: it imports neither JAX nor anything of the
JAX package, and its entry points never run on the CPU unasked."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = "robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu"
PORT_PKG = JAX_PKG + "_torch"
PORT_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in (REPO / PORT_PKG).rglob("*.py")
)

_PROBE = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None  # any import of these raises ImportError
import importlib
for mod in sys.argv[1:]:
    importlib.import_module(mod)
jax_pkg = {jax_pkg!r}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
             and sys.modules[m] is not None
             or m == jax_pkg or m.startswith(jax_pkg + "."))
print("LOADED", bad)
"""


def test_port_and_chip_smoke_import_without_jax():
    assert len(PORT_MODULES) > 15
    for sub in ("exp", "analysis", "train"):  # the JAX-free modules kept as copies
        assert f"{PORT_PKG}.{sub}" in PORT_MODULES
        assert any(m.startswith(f"{PORT_PKG}.{sub}.") for m in PORT_MODULES), sub
    for mod in ("models.d2v_masking", "models.d2v_pretrain", "train.d2v_pretrain",
                "data.binarized",  # d2v pretraining
                "parallel.mesh", "parallel.sharded",  # the process grid
                "tools.torch_replica", "tools.run_parity", "tools.pool_parity"):  # parity
        assert f"{PORT_PKG}.{mod}" in PORT_MODULES, mod
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-c", _PROBE.format(jax_pkg=JAX_PKG), *PORT_MODULES, "chip_smoke"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout, res.stdout


def test_port_sources_never_name_the_jax_package():
    named = re.compile(re.escape(JAX_PKG) + r"(?!_torch)")
    offenders = [
        str(p.relative_to(REPO))
        for p in (REPO / PORT_PKG).rglob("*")
        if p.suffix in (".py", ".cu", ".cuh") and named.search(p.read_text())
    ]
    assert offenders == []
    imports = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b", re.M)
    assert not [p for p in (REPO / PORT_PKG).rglob("*.py") if imports.search(p.read_text())]


@pytest.mark.parametrize("entry", ["FeatureExtractor", "EmotionPredictor", "cli",
                                   "init_fused", "norm_probe", "pretrain", "experiment",
                                   "tsne", "d2v-pretrain", "torch_replica", "run_parity"])
def test_entry_points_without_device_raise_without_cuda(monkeypatch, entry):
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
        cli,
    )
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
        EncoderConfig,
        dad_preset,
        pretrain_preset,
    )
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.eval.serving import (
        EmotionPredictor,
    )
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (
        FeatureExtractor,
        SSRLState,
    )

    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops import (
        norm_probe,
    )
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
        FusedConfig,
        init_fused,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "init_fused":
            init_fused(FusedConfig(), {})
        elif entry == "norm_probe":
            norm_probe.run_probe()
        elif entry == "FeatureExtractor":
            FeatureExtractor(EncoderConfig(embed_dim=16, num_heads=2), {})
        elif entry == "EmotionPredictor":
            EmotionPredictor(dad_preset("iemocap"), SSRLState({}, {}))
        elif entry == "pretrain":
            from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train.pretrain import (
                pretrain_fold,
            )

            pretrain_fold(pretrain_preset("iemocap"), None, 0)
        elif entry == "experiment":
            from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.exp import (
                run_single_experiment,
            )

            run_single_experiment(dad_preset("iemocap"), "x", {})
        elif entry == "d2v-pretrain":
            args = cli.build_parser().parse_args(["d2v-pretrain", "--manifests", "unused",
                                                  "--save-dir", "unused"])
            assert args.device == "cuda"
            args.func(args)
        elif entry == "torch_replica":
            from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.tools.torch_replica import (
                pretrain_fold_torch,
            )

            pretrain_fold_torch(pretrain_preset("iemocap"), None, 0)
        elif entry == "run_parity":
            from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.tools import (
                run_parity,
            )

            run_parity.main(["--seeds", "1"])
        elif entry == "tsne":
            from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.analysis.tsne import (
                make_embedder,
            )

            make_embedder(dad_preset("iemocap"), {})
        else:
            parser = cli.build_parser()
            args = parser.parse_args(["serve", "--weights", "unused.pth"])
            assert args.device == "cuda"
            monkeypatch.setattr(
                "robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert.load_torch_file",
                lambda path: {f"{role}_{k}": torch.zeros(1) for role in ("student", "teacher")
                              for k in ("encoder.pre_net.weight", "encoder.pre_net.bias",
                                        "classifier.fc_layer.weight", "classifier.fc_layer.bias")},
            )
            args.func(args)
