"""PyTorch port: training (``repro_torch.train``, ``launch.train`` and the
``train_small`` example) against the JAX package's.

Data: ``synth_batch`` draws the reference's tokens, frames and patches bit
for bit.  Optimizer: ``schedule``, ``global_norm`` and ``apply_updates`` on
the same numpy gradients agree within 1e-6 relative in f32 (XLA and torch
evaluate ``cos`` and ``pow`` and sum the norm's leaves in their own ways).
One train step of each of the reference's five training families
(``tests/test_models.py``) in f32, on the reference's weights converted:
the loss within 1e-5, the grad norm within 1e-5 relative, each moment
within 1e-5 of its leaf's largest value, and every parameter within 1e-7 where its
reference gradient is at least 1e-6 (after clipping).  Below that an
element's first Adam update ``lr * g / (|g| + eps)`` turns on rounding
noise in ``g`` (eps = 1e-8): there the bound is ``2 * lr``, the most
two updates can differ by.  Elements with no gradient at all agree within
1e-7.  The port differentiates the plain route, as the reference's
CPU route does.

Checkpoints use the reference's layout, so a checkpoint of either package
restores in the other bit for bit.
"""

import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import init_model as jax_init  # noqa: E402
from repro.train import OptimizerConfig as JaxOpt  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import init_opt_state as jax_opt_state  # noqa: E402
from repro.train import make_prefill_step as jax_prefill  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import init_model, loss_fn  # noqa: E402
from repro_torch.train import (  # noqa: E402
    DataState, OptimizerConfig, checkpoint as ckpt, init_opt_state,
    make_decode_step, make_prefill_step, make_train_step, next_batch,
    synth_batch,
)
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402

FAMILIES = ["stablelm-1.6b", "mixtral-8x7b", "rwkv6-3b", "hymba-1.5b", "whisper-tiny"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# the reference's init, compiled once per config (op by op it takes seconds)
jax_init_jit = jax.jit(jax_init, static_argnums=0)


def converted(arch, dtype, key=1):
    cj = dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype)
    ct = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    params = jax_init_jit(cj, jax.random.PRNGKey(key))
    return cj, ct, params, params_from_jax(jax.tree.map(np.asarray, params),
                                           device="cpu")


def snapshot(tree):
    return [t.detach().clone() for t in tree_leaves(tree)]


def by_path(tree, prefix=""):
    """A port tree's tensors by path (dict keys and list indices)."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(by_path(v, f"{prefix}/{k}"))
    return out


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_synth_batch_bit_equal(arch):
    cj, ct = jax_config(arch, reduced=True), get_config(arch, reduced=True)
    for seed, step in ((0, 0), (3, 7), (123, 2)):
        want = jdata.synth_batch(cj, 2, 16, jdata.DataState(seed, step))
        got = synth_batch(ct, 2, 16, DataState(seed, step), device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == {"tokens": torch.int32}.get(k, torch.float32)
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (k, seed, step)
    b, ds = next_batch(ct, 2, 4, DataState(5, 9), device="cpu")
    assert ds == DataState(5, 10) and DataState.from_dict(ds.as_dict()) == ds


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_schedule_and_global_norm_match():
    cfg, jcfg = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100), \
        JaxOpt(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(joptim.schedule(jcfg, jnp.int32(s)))
        assert float(optim.schedule(cfg, torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(want, rel=1e-6)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": [rng.standard_normal(3).astype(np.float32)]}
    want = float(joptim.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(optim.global_norm(optim.tree_map(torch.from_numpy, tree)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_apply_updates_matches_on_the_same_gradients(clip):
    """Three AdamW steps on bf16 and f32 parameters with the same numpy
    gradients: parameters, moments and metrics in place, within 1e-6."""
    rng = np.random.default_rng(1)
    p_np = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    jcfg, cfg = JaxOpt(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip), \
        OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip)
    jp = {"w": jnp.asarray(p_np["w"]).astype(jnp.bfloat16), "b": jnp.asarray(p_np["b"])}
    pt = {"w": torch.from_numpy(p_np["w"].copy()).bfloat16(),
          "b": torch.from_numpy(p_np["b"].copy())}
    js, ts = joptim.init_opt_state(jp), optim.init_opt_state(pt)
    assert all(t.dtype == torch.float32 for t in tree_leaves(ts["mu"]))
    w_addr = pt["w"].data_ptr()
    for _ in range(3):
        g = {"w": rng.standard_normal((6, 5)).astype(np.float32) * 3,
             "b": rng.standard_normal(5).astype(np.float32)}
        jp, js, jm = joptim.apply_updates(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        out = optim.apply_updates(cfg, pt, optim.tree_map(torch.from_numpy, g), ts)
        assert out[0] is pt and out[1] is ts and pt["w"].data_ptr() == w_addr
        for k in ("grad_norm", "lr"):
            assert float(out[2][k]) == pytest.approx(float(jm[k]), rel=1e-6)
        for a, b in ((pt, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
            for k in a:
                np.testing.assert_allclose(f32(a[k]), f32(b[k]), rtol=1e-6, atol=1e-7)
        assert int(ts["step"]) == int(js["step"])
    assert pt["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# one train step of each training family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_one_train_step_matches_the_reference(arch):
    cj, ct, params, pt = converted(arch, "float32")
    jb = jdata.synth_batch(cj, 2, 16, jdata.DataState(0, 0))
    tb = synth_batch(ct, 2, 16, DataState(0, 0), device="cpu")
    jp, jo, jm = jax.jit(jax_train_step(cj, JaxOpt(**OPT), remat="none"))(
        params, jax_opt_state(params), jb)
    before = snapshot(pt)
    ot = init_opt_state(pt)
    pt2, ot2, m = make_train_step(ct, OptimizerConfig(**OPT), remat="none")(pt, ot, tb)
    assert pt2 is pt and int(ot2["step"]) == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert not any(t.requires_grad for t in tree_leaves(pt))
    want_p = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    want_o = opt_state_from_jax(jax.tree.map(np.asarray, jo), device="cpu")
    lr = float(jm["lr"])
    changed = 0
    for got, want, mu, mu_w, b in zip(tree_leaves(pt), want_p, tree_leaves(ot2["mu"]),
                                      tree_leaves(want_o["mu"]), before):
        assert float((mu - mu_w).abs().max()) <= 1e-5 * float(mu_w.abs().max())
        err = (got - want).abs().numpy()
        # mu = (1 - b1) * g after one step: |g| >= 1e-6 <=> |mu| >= 1e-7
        firm = mu_w.abs().numpy() >= 1e-7
        none = mu_w.numpy() == 0
        assert err[firm].max(initial=0) <= 1e-7
        assert err[none].max(initial=0) <= 1e-7
        assert err.max() <= 2 * lr
        changed += int(not torch.equal(got, b))
    assert changed == len(before)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mixtral-8x7b", "whisper-tiny"])
def test_remat_changes_no_value(arch, remat):
    """``remat`` recomputes activations in the backward and changes no
    value: loss, grad norm and every parameter after a step bit-equal to
    ``"none"``."""
    _, ct, _, pt = converted(arch, "float32")
    batch = synth_batch(ct, 2, 16, DataState(0, 0), device="cpu")
    outs = []
    for r in ("none", remat):
        p = optim.tree_map(torch.clone, pt)
        p, _, m = make_train_step(ct, OptimizerConfig(**OPT), remat=r)(
            p, init_opt_state(p), batch)
        outs.append((float(m["loss"]), float(m["grad_norm"]), tree_leaves(p)))
    (l0, g0, p0), (l1, g1, p1) = outs
    assert (l0, g0) == (l1, g1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_microbatches_match_the_full_batch():
    """The reference's test: 2 microbatches against 1 on reduced stablelm
    (bf16), loss within 2e-2; and the port's 2-microbatch step against the
    reference's in f32."""
    _, ct, _, pt = converted("stablelm-1.6b", "bfloat16", key=2)
    batch = synth_batch(ct, 2, 16, DataState(2, 0), device="cpu")
    losses = []
    for mb in (1, 2):
        p = optim.tree_map(torch.clone, pt)
        _, _, m = make_train_step(ct, OptimizerConfig(), microbatches=mb,
                                  remat="none")(p, init_opt_state(p), batch)
        losses.append(float(m["loss"]))
    assert abs(losses[0] - losses[1]) < 2e-2
    cj, ct, params, pt = converted("stablelm-1.6b", "float32", key=2)
    jb = jdata.synth_batch(cj, 4, 16, jdata.DataState(2, 0))
    _, _, jm = jax.jit(jax_train_step(cj, JaxOpt(**OPT), microbatches=2,
                                      remat="none"))(params, jax_opt_state(params), jb)
    _, _, m = make_train_step(ct, OptimizerConfig(**OPT), microbatches=2, remat="none")(
        pt, init_opt_state(pt), synth_batch(ct, 4, 16, DataState(2, 0), device="cpu"))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(ct, OptimizerConfig(), microbatches=3)(
            pt, init_opt_state(pt), synth_batch(ct, 4, 16, DataState(2, 0), device="cpu"))


def test_prefill_and_decode_steps_match():
    cj, ct, params, pt = converted("stablelm-1.6b", "float32")
    tokens = np.random.default_rng(0).integers(0, cj.vocab_size, (2, 6)).astype(np.int32)
    want = np.asarray(jax.jit(jax_prefill(cj, backend="ref"))(params, {"tokens": tokens}))
    got = make_prefill_step(ct)(pt, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    from repro_torch.models import init_caches

    caches = init_caches(ct, 2, 6, device="cpu")
    step = make_decode_step(ct)
    for t in range(6):
        logits, caches = step(pt, caches, torch.from_numpy(tokens[:, t:t + 1]), t)
    np.testing.assert_allclose(logits.numpy(), want, atol=1e-4)


# ---------------------------------------------------------------------------
# the gradient guard and the reference-side finding behind it
# ---------------------------------------------------------------------------
class _CudaLike:
    """Stands in for a CUDA tensor: the guard reads only these two."""

    is_cuda = True

    def __init__(self, requires_grad: bool):
        self.requires_grad = requires_grad


def test_use_kernel_refuses_inputs_that_require_grad():
    with pytest.raises(RuntimeError, match="require grad"):
        ops.use_kernel(_CudaLike(True), "auto")
    with pytest.raises(RuntimeError, match="require grad"):
        ops.refuse_grad(_CudaLike(False), _CudaLike(True))
    assert ops.use_kernel(_CudaLike(False), "auto")
    ops.refuse_grad(_CudaLike(False), _CudaLike(False))
    with torch.no_grad():
        assert ops.use_kernel(_CudaLike(True), "auto")
        ops.refuse_grad(_CudaLike(True))
    assert not ops.use_kernel(_CudaLike(True), "ref")
    # a CPU tensor takes the plain version, which differentiates
    assert not ops.use_kernel(torch.ones(2, requires_grad=True), "auto")


def test_train_step_differentiates_the_plain_route(monkeypatch):
    """The step passes backend="ref": nothing asks for a kernel."""
    calls = []
    real = ops.use_kernel

    def spy(x, backend):
        calls.append(backend)
        return real(x, backend)

    monkeypatch.setattr(ops, "use_kernel", spy)
    _, ct, _, pt = converted("stablelm-1.6b", "float32")
    make_train_step(ct, OptimizerConfig(**OPT))(
        pt, init_opt_state(pt), synth_batch(ct, 2, 8, DataState(0, 0), device="cpu"))
    assert calls and set(calls) == {"ref"}


def test_reference_pallas_flash_cannot_be_differentiated():
    """Why the reference's own train step cannot take its flash route
    (``launch/dryrun.py`` lowers it with ``backend="ref"``): ``jax.grad``
    through the interpreted Pallas kernel raises."""
    from repro.kernels import ops as jops

    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 2, 16, 32)).astype(np.float32))
               for _ in range(3))

    def loss(q):
        return jops.flash_attention(q, k, v, backend="pallas_interpret").sum()

    with pytest.raises(Exception):
        jax.grad(loss)(q)
    assert np.isfinite(float(jax.grad(lambda q: jops.flash_attention(
        q, k, v, backend="ref").sum())(q).sum()))


# ---------------------------------------------------------------------------
# checkpoints: the reference's four tests, ported, and across packages
# ---------------------------------------------------------------------------
@pytest.fixture
def setup(tmp_path):
    cfg = get_config("stablelm-1.6b", reduced=True)
    params = init_model(cfg, 0, device="cpu")
    return cfg, params, init_opt_state(params), str(tmp_path / "ckpt")


def test_save_restore_roundtrip(setup):
    cfg, params, opt, d = setup
    ckpt.save(d, 3, params, opt, data_state={"seed": 7, "step": 3})
    p2, o2, meta, step = ckpt.restore(d, params, opt)
    assert step == 3 and meta["data_state"]["seed"] == 7
    for a, b in zip(tree_leaves(params), tree_leaves(p2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves(opt), tree_leaves(o2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_pointer_and_overwrite(setup):
    cfg, params, opt, d = setup
    ckpt.save(d, 1, params, opt)
    ckpt.save(d, 5, params, opt)
    assert ckpt.latest_step(d) == 5


def test_digest_detects_corruption(setup):
    import os

    cfg, params, opt, d = setup
    path = ckpt.save(d, 1, params, opt)
    data = open(os.path.join(path, "arrays.npz"), "rb").read()
    with open(os.path.join(path, "arrays.npz"), "wb") as f:
        f.write(data[:100] + bytes([data[100] ^ 0xFF]) + data[101:])
    with pytest.raises(Exception):
        ckpt.restore(d, params, opt)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mixtral-8x7b"])
def test_training_resume_is_bit_identical(setup, arch):
    """Kill-and-restart at step 2 reproduces the uninterrupted run
    exactly (checkpoint + deterministic data)."""
    _, _, _, d = setup
    cfg = get_config(arch, reduced=True)
    params = init_model(cfg, 0, device="cpu")
    step_fn = make_train_step(cfg, OptimizerConfig(lr=1e-3), remat="none")

    p, o, ds = optim.tree_map(torch.clone, params), None, DataState(seed=0, step=0)
    o = init_opt_state(p)
    for _ in range(4):
        batch, ds = next_batch(cfg, 2, 16, ds, device="cpu")
        p, o, _ = step_fn(p, o, batch)
    straight = snapshot(p)

    p, ds = optim.tree_map(torch.clone, params), DataState(seed=0, step=0)
    o = init_opt_state(p)
    for _ in range(2):
        batch, ds = next_batch(cfg, 2, 16, ds, device="cpu")
        p, o, _ = step_fn(p, o, batch)
    ckpt.save(d, 2, p, o, data_state=ds.as_dict())

    p2, o2, meta, _ = ckpt.restore(d, init_model(cfg, 9, device="cpu"),
                                   init_opt_state(p))
    ds2 = DataState.from_dict(meta["data_state"])
    for _ in range(2):
        batch, ds2 = next_batch(cfg, 2, 16, ds2, device="cpu")
        p2, o2, _ = step_fn(p2, o2, batch)
    for a, b in zip(straight, tree_leaves(p2)):
        assert torch.equal(a, b), "resume diverged"


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-v2-lite-16b", "whisper-tiny"])
def test_checkpoints_restore_across_packages(arch, tmp_path):
    """The reference's checkpoint restores in the port bit for bit, and the
    port's in the reference: the same keys (stacked layers, list entries
    by index, ``opt/step``) and bytes."""
    cj, ct = jax_config(arch, reduced=True), get_config(arch, reduced=True)
    params = jax_init_jit(cj, jax.random.PRNGKey(0))
    # moments of the parameters' shapes with values of their own
    jopt = jax.jit(lambda p: {
        "mu": jax.tree.map(lambda x: 0.5 * x.astype(jnp.float32), p),
        "nu": jax.tree.map(lambda x: jnp.abs(x).astype(jnp.float32), p),
        "step": jnp.int32(7)})(params)
    jckpt.save(str(tmp_path / "ref"), 7, params, jopt, data_state={"seed": 1, "step": 7})

    like_p = init_model(ct, 3, device="cpu")
    like_o = init_opt_state(like_p)
    pt, ot, meta, step = ckpt.restore(str(tmp_path / "ref"), like_p, like_o)
    assert step == 7 and meta["data_state"] == {"seed": 1, "step": 7}
    want_p = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    want_o = opt_state_from_jax(jax.tree.map(np.asarray, jopt), device="cpu")
    got, want = by_path([pt, ot]), by_path([want_p, want_o])
    assert sorted(got) == sorted(want)
    assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
               for k in want)

    ckpt.save(str(tmp_path / "port"), 7, pt, ot, data_state=meta["data_state"])
    jp, jo, jmeta, _ = jckpt.restore(str(tmp_path / "port"), params, jopt)
    for a, b in zip(jax.tree.leaves((jp, jo)), jax.tree.leaves((params, jopt))):
        assert a.dtype == b.dtype and np.array_equal(f32(a), f32(b))
    with np.load(tmp_path / "ref" / "step_00000007" / "arrays.npz") as zr, \
            np.load(tmp_path / "port" / "step_00000007" / "arrays.npz") as zp:
        assert sorted(zr.files) == sorted(zp.files)
        assert all(zr[k].dtype == zp[k].dtype and np.array_equal(zr[k], zp[k])
                   for k in zr.files)
        stacked = ("params/dec_layers/cross/wk" if arch == "whisper-tiny"
                   else "params/layers/ln1")
        assert {"opt/step", stacked} <= set(zp.files)
        assert zp[stacked].shape[0] == ct.n_layers


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------
def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train

    d = str(tmp_path / "a")
    base = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--log-every", "2"]
    out = train.main(base + ["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2"])
    text = capsys.readouterr().out
    assert "arch=stablelm-1.6b-reduced params=0.2M steps=4 batch=2x16" in text
    assert "step     4  loss" in text and "done: loss" in text
    assert ckpt.latest_step(d) == 4 and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"])) and min(out["grad_norms"]) > 0
    # a restart from step 2 (the straight run saved it on the way)
    # reproduces the run's step 4 bit for bit
    r = tmp_path / "b"
    r.mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000002", r / "step_00000002")
    (r / "LATEST").write_text("step_00000002")
    again = train.main(base + ["--steps", "4", "--ckpt-dir", str(r)])
    assert "resumed from step 2" in capsys.readouterr().out and again["start"] == 2
    for a, b in zip(tree_leaves(out["params"]) + tree_leaves(out["opt_state"]),
                    tree_leaves(again["params"]) + tree_leaves(again["opt_state"])):
        assert torch.equal(a, b)
    # and on to step 6 from LATEST
    train.main(base + ["--steps", "6", "--ckpt-dir", d])
    assert "resumed from step 4" in capsys.readouterr().out
    assert ckpt.latest_step(d) == 6


def test_launcher_trains_whisper_with_remat(capsys):
    from repro_torch.launch import train

    out = train.main(["--reduced", "--arch", "whisper-tiny", "--device", "cpu",
                      "--batch", "2", "--seq", "8", "--steps", "2",
                      "--remat", "full", "--log-every", "1"])
    assert "arch=whisper-tiny-reduced" in capsys.readouterr().out
    assert all(np.isfinite(out["losses"]))


def test_train_small_config_is_the_reference_example(tmp_path, monkeypatch, capsys):
    """The example's config field for field (78.3 M parameters, as the
    reference example prints), and a short run: its lines, checkpoints
    and exit code."""
    from repro_torch.examples import train_small
    from test_torch_families import _fields

    want = dataclasses.replace(
        jax_config("qwen3-4b"), name="qwen3-100m", n_layers=8, d_model=640,
        n_heads=10, n_kv_heads=5, head_dim=64, d_ff=1792, vocab_size=32000)
    got = train_small.small_config()
    assert _fields(got) == _fields(want)
    small = dataclasses.replace(got, d_model=64, n_heads=2, n_kv_heads=1,
                                head_dim=32, d_ff=64, vocab_size=512, n_layers=2)
    monkeypatch.setattr(train_small, "small_config", lambda: small)
    d = str(tmp_path / "c")
    try:
        train_small.main(["--steps", "40", "--batch", "2", "--seq", "16",
                          "--ckpt-dir", d, "--device", "cpu"])
    except SystemExit as e:
        pytest.fail(f"the example exited {e.code}")
    text = capsys.readouterr().out
    assert "qwen3-100m: " in text and "step   40  loss" in text
    assert ckpt.latest_step(d) == 40
    n = sum(x.numel() for x in tree_leaves(init_model(got, 0, device="cpu")))
    assert round(n / 1e6, 1) == 78.3


def test_training_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.examples import train_small
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_small.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth_batch(get_config("qwen3-4b", reduced=True), 1, 2, DataState(0, 0))
    assert loss_fn(get_config("whisper-tiny")).__name__ == "encdec_loss"
    assert loss_fn(get_config("qwen3-4b")).__name__ == "lm_loss"
