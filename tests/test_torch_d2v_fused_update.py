"""d2v's optimizer step and EMA as one multi-tensor pass
(``ops/d2v_update.py``, ``csrc/d2v_update.cu``), held to the per-leaf
update (``models/d2v_pretrain.py::optimizer_and_ema_per_leaf``).

On the CPU: the launch plan covers every element once, the wrapper refuses
the types the kernel does not take, and ``optimizer_and_ema`` on CPU
tensors is the per-leaf code bit for bit and leaves its input alone. On
the card (``cuda`` marker; they skip without a GPU): the kernel against
the per-leaf code on the same CUDA inputs at e2v-base's leaf set, its
launches, its determinism, and that it makes no host-device sync.

This file imports neither JAX nor the JAX package, so the card tests run
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_d2v_fused_update.py
"""

import bisect

import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    D2vPretrainConfig,
    EncoderConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (
    d2v_pretrain as td2v,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops import (
    d2v_update as du,
)

C = du.CHUNK


@pytest.mark.parametrize("numels", [
    [1], [C], [C + 1], [0, 5, 0], [3 * C + 5, 1, C - 1, 2 * C],
    [int(x) for x in np.random.default_rng(0).integers(1, 2 * C + 3, size=3 * du.MAX_LEAVES + 7)],
    [1] * (du.MAX_LEAVES + 1),
], ids=["one", "chunk", "chunk+1", "empty", "mixed", "many", "max+1"])
def test_plan_covers_every_element_once(numels):
    """Block b of a launch takes [c CHUNK, (c + 1) CHUNK) of the last leaf
    of the launch whose first block is <= b (csrc/d2v_update.cu's leaf_of
    and chunk arithmetic): every element of every leaf once, no empty block,
    launches of at most MAX_LEAVES leaves in order, partials numbered on."""
    first_block, launches = du.update_plan(numels)
    covered = [[] for _ in numels]
    next_leaf = partial = 0
    for lo, hi, grid, base in launches.tolist():
        assert lo == next_leaf and 1 <= hi - lo <= du.MAX_LEAVES and base == partial
        starts = first_block[lo:hi].tolist()
        for b in range(grid):
            leaf = lo + bisect.bisect_right(starts, b) - 1
            c = b - starts[leaf - lo]
            begin, end = c * C, min(numels[leaf], (c + 1) * C)
            assert begin < end, (b, leaf)
            covered[leaf].append((begin, end))
        next_leaf, partial = hi, partial + grid
    assert next_leaf == len(numels)
    for n, spans in zip(numels, covered):
        at = 0
        for begin, end in sorted(spans):
            assert begin == at
            at = end
        assert at == n


def _leaves(shapes, gen, scale=1.0, dtype=torch.float32, device="cpu"):
    return {k: (torch.randn(s, generator=gen, device=device) * scale).to(dtype)
            for k, s in shapes.items()}


SMALL = {"block_0.attn.qkv.weight": (9, 3), "block_0.attn.qkv.bias": (9,),
         "decoder.proj.weight": (4, 4), "local.conv.bias": (6,)}


def _small_case(mu_dtype=torch.float32, ema_dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    params = _leaves(SMALL, gen)
    mu = _leaves(SMALL, gen, 0.1, mu_dtype)
    nu = {k: v * v for k, v in _leaves(SMALL, gen, 0.1).items()}
    ema = {k: (v + 0.01).to(ema_dtype) for k, v in params.items() if k.startswith("block_")}
    grads = _leaves(SMALL, gen)
    grads["block_0.attn.qkv.bias"] = None
    count = torch.tensor(3, dtype=torch.int32)
    hyper = du.Hyper(0.9, 0.98, 1e-8, 0.01, 1.5)
    return params, grads, mu, nu, ema, count, hyper


@pytest.mark.parametrize("what", ["mu stored in another type", "f16 params", "f16 EMA",
                                  "bf16 grads", "f16 mu"])
def test_fused_update_refuses_what_the_kernel_does_not_take(what):
    params, grads, mu, nu, ema, count, hyper = _small_case()
    mu_dtype = torch.float32
    if what == "mu stored in another type":
        mu = {k: v.bfloat16() for k, v in mu.items()}
    elif what == "f16 params":
        params = {k: v.half() for k, v in params.items()}
    elif what == "f16 EMA":
        ema = {k: v.half() for k, v in ema.items()}
    elif what == "bf16 grads":
        grads = {k: None if v is None else v.bfloat16() for k, v in grads.items()}
    else:
        mu, mu_dtype = {k: v.half() for k, v in mu.items()}, torch.float16
    s = torch.tensor(0.5)
    with pytest.raises(TypeError, match="d2v_update kernel .*(f32|bf16)"):
        du.fused_update(params, grads, mu, nu, ema, hyper, mu_dtype, s, s, s, s)


def test_fused_update_refuses_tensors_off_the_card():
    """Tensors of the kernel's types on the CPU are refused, naming the
    per-leaf update as the CPU's; nothing falls back."""
    params, grads, mu, nu, ema, _count, hyper = _small_case()
    s = torch.tensor(0.5)
    with pytest.raises(ValueError, match="runs on CUDA tensors.*per-leaf"):
        du.fused_update(params, grads, mu, nu, ema, hyper, torch.float32, s, s, s, s)


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("ema_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("given_norm", [False, True])
def test_cpu_wrapper_is_the_per_leaf_code(mu_dtype, ema_dtype, grad_scale, given_norm):
    """On CPU tensors ``optimizer_and_ema`` is ``D2vOptimizer.update``, the
    parameters plus its updates, and the EMA in f32 at ``annealed_decay``,
    bit for bit; its input state stays as it was."""
    pcfg = D2vPretrainConfig(warmup_steps=2, max_steps=6, learning_rate=1e-2, grad_clip=1.5,
                             adam_mu_dtype=mu_dtype, ema_dtype=ema_dtype, ema_decay=0.99,
                             ema_end_decay=0.999, ema_anneal_end_step=10)
    tx = td2v.build_d2v_optimizer(pcfg)
    mt = torch.bfloat16 if mu_dtype else torch.float32
    params, grads, mu, nu, ema, count, _ = _small_case(mt, getattr(torch, ema_dtype))
    grads = {k: None if g is None else g * grad_scale for k, g in grads.items()}
    state = td2v.D2vTrainState(params, ema, td2v.D2vAdamState(count, mu, nu), count + 2)
    before = {k: [t.clone() for t in d.values()] for k, d in
              (("p", params), ("mu", mu), ("nu", nu), ("ema", ema))}
    norm = torch.tensor(2.5) if given_norm else None
    got, decay = td2v.optimizer_and_ema(tx, pcfg, state, params, grads, norm)

    zeros = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
    updates, want_opt = tx.update(zeros, state.opt_state, params, norm)
    want_p = {k: p + updates[k] for k, p in params.items()}
    want_decay = td2v.annealed_decay(pcfg, state.step)
    want_ema = {k: (want_decay * e.float() + (1.0 - want_decay) * want_p[k].float()).to(e.dtype)
                for k, e in ema.items()}
    assert torch.equal(decay, want_decay)
    assert int(got.step) == int(state.step) + 1 and int(got.opt_state.count) == 4
    for got_d, want_d in ((got.params, want_p), (got.ema_blocks, want_ema),
                          (got.opt_state.mu, want_opt.mu), (got.opt_state.nu, want_opt.nu)):
        assert list(got_d) == list(want_d)
        for k in want_d:
            assert got_d[k].dtype == want_d[k].dtype and torch.equal(got_d[k], want_d[k]), k
    for name, d in (("p", params), ("mu", mu), ("nu", nu), ("ema", ema)):
        for t, b in zip(d.values(), before[name]):
            assert torch.equal(t, b), name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    """Skips unless a CUDA device is present, decided at run time so that
    every pytest-xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: pytest --noconftest -m cuda)")
    return torch.device("cuda")


def _e2v_base(mu_dtype, ema_dtype, count, device):
    """(pcfg, tx, state, grads at 3 updates' scale 1): e2v-base's 193 d2v
    leaves (93,737,600 parameters, the 8 blocks' 96 in the EMA) with seeded
    values, the first qkv bias without a gradient."""
    pcfg = D2vPretrainConfig(adam_mu_dtype=mu_dtype, ema_dtype=ema_dtype)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in
                  td2v.D2vPretrainModel(EncoderConfig(), pcfg).state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(count)
    params = _leaves(shapes, gen, 0.05, device=device)
    mt = torch.bfloat16 if mu_dtype else torch.float32
    mu = _leaves(shapes, gen, 0.01, mt, device)
    nu = {k: v * v for k, v in _leaves(shapes, gen, 0.01, device=device).items()}
    ema = {k: (e.float() + 0.01 * torch.randn(e.shape, generator=gen, device=device)).to(e.dtype)
           for k, e in td2v.init_ema_blocks(params, EncoderConfig(), pcfg).items()}
    c = torch.tensor(count, dtype=torch.int32, device=device)
    state = td2v.D2vTrainState(params, ema, td2v.D2vAdamState(c, mu, nu), c.clone())
    return pcfg, td2v.build_d2v_optimizer(pcfg), state, shapes, gen


def _grads(shapes, gen, scale, device):
    grads = _leaves(shapes, gen, scale, device=device)
    grads[next(k for k in grads if k.endswith("qkv.bias"))] = None  # read as zeros
    return grads


def _ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits)."""
    _m, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


CARD_CASES = {
    # mu, EMA, gradient scale (N(0, 1) over 93.7M elements: a norm of ~9.7e3,
    # clipped at 4; x 1e-5: ~0.1, not clipped), count (warmup 8000), norm given
    "f32-clipped-cosine": (None, "float32", 1.0, 9000, False),
    "bf16-clipped-warmup": ("bfloat16", "bfloat16", 1.0, 100, False),
    "given-unclipped-warmup": (None, "bfloat16", 1e-5, 100, True),
    "given-clipped-cosine": ("bfloat16", "float32", 1.0, 9000, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_fused_update_matches_per_leaf_on_the_card(cuda_device, case):
    """3 updates of the kernel and of the per-leaf code from one state on
    the same gradients. count, step and the decay exactly. Given the norm
    (the ``given-*`` cases) both sides run the same f32 operations on the
    same scalars: every leaf of all four states bit for bit. Taking their
    own norms they sum in other orders, so: parameters, nu and f32 moments
    and EMA copies within 1e-5 of each leaf's largest value; bf16 leaves
    within one bf16 ulp of it (a rounding that the norm flips, carried
    into the next updates at b1 or the decay times its size). A first
    moment flipped by a bf16 ulp moves its parameter's Adam step (~lr) by
    up to 2^-7 of it: the parameters take that on top in the bf16 cases.
    Both sides get the same gradients, so the key-bias slice's rounding
    noise, which the JAX-parity tests' carve-out is for, is the same on
    both."""
    mu_dtype, ema_dtype, scale, count, given = CARD_CASES[case]
    pcfg, tx, state, shapes, gen = _e2v_base(mu_dtype, ema_dtype, count, cuda_device)
    fused = plain = state
    steps = 3
    for _ in range(steps):
        grads = _grads(shapes, gen, scale, cuda_device)
        norm = None
        if given:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values() if g is not None))
        fused, d_f = td2v.optimizer_and_ema(tx, pcfg, fused, fused.params, grads, norm)
        plain, d_p = td2v.optimizer_and_ema_per_leaf(tx, pcfg, plain, plain.params, grads, norm)
        assert torch.equal(d_f, d_p) and d_f.dtype == d_p.dtype
        assert int(fused.step) == int(plain.step) and int(fused.opt_state.count) == int(
            plain.opt_state.count)
    assert int(fused.step) == count + steps
    if given:
        for name, got, want in (("params", fused.params, plain.params),
                                ("mu", fused.opt_state.mu, plain.opt_state.mu),
                                ("nu", fused.opt_state.nu, plain.opt_state.nu),
                                ("ema", fused.ema_blocks, plain.ema_blocks)):
            assert list(got) == list(want)
            differ = [k for k, w in want.items()
                      if not (got[k].dtype == w.dtype and torch.equal(got[k], w))]
            assert not differ, (name, len(differ), differ[:5])
        return
    p_atol = steps * pcfg.learning_rate * 2.0**-7 if mu_dtype else 0.0
    for name, got, want, atol in (
            ("params", fused.params, plain.params, p_atol),
            ("mu", fused.opt_state.mu, plain.opt_state.mu, 0.0),
            ("nu", fused.opt_state.nu, plain.opt_state.nu, 0.0),
            ("ema", fused.ema_blocks, plain.ema_blocks, 0.0)):
        assert list(got) == list(want)
        ratios = []  # each leaf's largest gap over what it is allowed
        for k, w in want.items():
            g = got[k]
            assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
            top = w.float().abs().max()
            tol = _ulp_bf16(top) if w.dtype == torch.bfloat16 else 1e-5 * top + atol
            ratios.append((g.float() - w.float()).abs().max() / tol)
        worst = torch.stack(ratios).tolist()
        failed = sorted(((r, k) for k, r in zip(want, worst) if not r <= 1.0), reverse=True)
        assert not failed, (name, len(failed), failed[:5])


@pytest.mark.cuda
def test_fused_update_launches_deterministic_and_without_sync(cuda_device):
    """The kernel's launches (4 of the sum of squares, 1 finalize, 4 of the
    update at 193 leaves; the update's 4 alone given the norm), two runs
    from one state bit-equal, and no host-device sync inside the update
    (the per-leaf code makes one, which the debug mode catches)."""
    pcfg, tx, state, shapes, gen = _e2v_base(None, "float32", 9000, cuda_device)
    grads = _grads(shapes, gen, 1.0, cuda_device)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values() if g is not None))
    runs = []
    torch.cuda.synchronize()
    for given in (None, None, norm):
        before = du.fused_update.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            runs.append(td2v.optimizer_and_ema(tx, pcfg, state, state.params, grads, given))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert du.fused_update.launches - before == (9 if given is None else 4)
    (a, da), (b, db), _ = runs
    assert torch.equal(da, db)
    for x, y in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu), (a.ema_blocks, b.ema_blocks)):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            td2v.optimizer_and_ema_per_leaf(tx, pcfg, state, state.params, grads)
    finally:
        torch.cuda.set_sync_debug_mode(0)
