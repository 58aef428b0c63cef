"""The port's native host library (``data/native.py``): its build from
``native/*.cc`` (the flags of ``native/build.sh``, under a file lock, a
temporary name replaced into place, no cached failure, a name that
follows the host's target), and its batcher (``NativeStore``) against the
JAX package's numpy batches, bit for bit.

The JAX package's own native tests load ``native/libdadtpu_native.so``,
which its loader builds without a lock; these build the port's copy
under ``csrc/build/`` and never touch that file.
"""

import os
import pathlib
import shlex
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data import (
    PaddedBatchIterator as JaxPaddedBatchIterator,
    load_feature_store as jax_load_feature_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.native import (
    npy_data_offset as jax_npy_data_offset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data import (
    load_feature_store,
    native,
)

from helpers import make_iemocap_dir
from torch_parity import native_batches

REPO = pathlib.Path(__file__).resolve().parent.parent
LM = {"ang": 0, "hap": 1, "neu": 2, "sad": 3}
FIELDS = ("feats", "padding_mask", "labels", "ids", "row_valid")


def test_build_uses_the_flags_and_sources_of_build_sh():
    script = (REPO / "native" / "build.sh").read_text()
    line = next(ln for ln in script.replace("\\\n", " ").splitlines()
                if ln.strip().startswith("g++"))
    words = shlex.split(line)[1:]
    out = words.index("-o")
    assert tuple(words[:out]) == native.CXX_FLAGS
    assert tuple(words[out + 2:]) == native.SOURCES
    assert native.NATIVE_DIR == REPO / "native"
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libdadtpu_native-")
    assert "csrc/build" in native.BUILD_DIR.as_posix()


def test_library_name_follows_the_host_target(monkeypatch):
    here = native.library_path()
    assert "-march=" in native._target(native._compiler())
    monkeypatch.setattr(native, "_target", lambda cxx: "-march= another-cpu")
    assert native.library_path() != here and native.library_path().parent == here.parent


_LOADER = textwrap.dedent("""
    import pathlib, sys
    from {pkg}.data import native
    native.BUILD_DIR = pathlib.Path(sys.argv[1])
    lib = native.native_lib()
    print("loaded", native.library_path().name, hasattr(lib, "inject_files"), flush=True)
""")


def test_six_processes_load_the_library_from_an_empty_build_dir(tmp_path):
    build = tmp_path / "build"
    code = _LOADER.format(pkg=native.__name__.split(".")[0])
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.split() == ["loaded", native.library_path().name, "True"]
    assert sorted(f.name for f in build.iterdir()) == sorted(
        [native.library_path().name, "libdadtpu_native.lock"])


def test_a_failed_build_raises_with_the_compiler_output_every_time(tmp_path, monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    for name in native.SOURCES:
        (src / name).write_text((REPO / "native" / name).read_text())
    (src / "inject.cc").write_text("int broken( {\n")
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    for _ in range(2):  # not cached
        with pytest.raises(RuntimeError, match="inject.cc"):
            native.build()
    assert not [f for f in (tmp_path / "build").iterdir() if f.suffix != ".lock"]
    (src / "inject.cc").write_text((REPO / "native" / "inject.cc").read_text())
    assert native.build() == native.library_path() and native.library_path().exists()


@pytest.mark.parametrize("max_frames", [None, 20])
@pytest.mark.parametrize("shuffle", [False, True])
def test_native_batches_equal_jax_numpy_batches(tmp_path, shuffle, max_frames):
    d, *_ = make_iemocap_dir(tmp_path, n=37, dim=8)
    kw = dict(batch_size=8, buckets=(16, 32), shuffle=shuffle, seed=3, max_frames=max_frames)
    jit = JaxPaddedBatchIterator(jax_load_feature_store(d, LM), use_native=False, **kw)
    assert jit._native is None
    store = load_feature_store(d, LM)
    for epoch in (0, 2):
        jit.set_epoch(epoch)
        want = list(jit)
        got = native_batches(store, want, max_frames)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
                assert getattr(g, f).dtype == getattr(w, f).dtype, f


def test_native_subset_view_and_withheld_labels(tmp_path):
    d, clips, *_ = make_iemocap_dir(tmp_path, n=20, dim=8)
    sub = load_feature_store(d, LM).subset([3, 7, 11])
    # the subset's offsets index the whole array; the trainer withholds
    # the noisy stream's labels
    ns = native.NativeStore(sub.feats, sub.sizes, sub.offsets, None)
    feats, mask, labels, valid = ns.assemble(np.array([0, 1, 2, -1]), 32)
    np.testing.assert_array_equal(feats[0, : len(clips[3])], clips[3])
    np.testing.assert_array_equal(feats[2, : len(clips[11])], clips[11])
    assert valid.tolist() == [True, True, True, False] and labels.tolist() == [-1] * 4
    assert mask[3].all() and not feats[3].any()


def test_native_store_reads_the_live_buffer(tmp_path):
    d, *_ = make_iemocap_dir(tmp_path, n=5, dim=8)
    store = load_feature_store(d, LM)
    ns = native.NativeStore(store.feats, store.sizes, store.offsets, store.labels)
    store.feats += 1.0  # in place: the C side holds this buffer
    feats, *_ = ns.assemble(np.arange(5), 32)
    np.testing.assert_array_equal(feats[0, : store.sizes[0]], store.clip(0))


def test_native_store_from_file_maps_the_npy(tmp_path):
    d, clips, *_ = make_iemocap_dir(tmp_path, n=6, dim=8)
    store = load_feature_store(d, LM)
    ns = native.NativeStore.from_file(store.npy_path, store.sizes, store.offsets, store.labels)
    feats, mask, labels, valid = ns.assemble(np.array([0, 5, -1]), 32)
    np.testing.assert_array_equal(feats[0, : len(clips[0])], clips[0])
    np.testing.assert_array_equal(feats[1, : len(clips[5])], clips[5])
    assert not valid[2] and labels[2] == -1 and labels[0] == store.labels[0]
    assert mask[0, len(clips[0]):].all() and not mask[0, : len(clips[0])].any()
    ns.close()
    ns.close()  # idempotent
    np.save(tmp_path / "f64.npy", np.zeros((3, 8)))
    with pytest.raises(ValueError, match="needs float32"):
        native.NativeStore.from_file(str(tmp_path / "f64.npy"), [3], [0], None)


@pytest.mark.parametrize("version", [(1, 0), (2, 0)])
def test_npy_data_offset_matches_jax(tmp_path, version):
    from numpy.lib import format as npy_format

    p = str(tmp_path / "x.npy")
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    with open(p, "wb") as f:
        npy_format.write_array(f, a, version=version)
    off = native.npy_data_offset(p)
    assert off == jax_npy_data_offset(p)
    np.testing.assert_array_equal(np.fromfile(p, dtype=np.float32, offset=off).reshape(3, 4), a)
    (tmp_path / "bad.npy").write_bytes(b"not numpy")
    with pytest.raises(ValueError, match="not a npy file"):
        native.npy_data_offset(str(tmp_path / "bad.npy"))
