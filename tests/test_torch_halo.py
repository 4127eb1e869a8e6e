"""The port's sequence-sharded transforms (`wam_tpu_torch.parallel.halo`,
`halo_modes`) held to the reference's (`wam_tpu.parallel.halo`,
`halo_modes`) on the virtual 8-device CPU mesh:

- forward and VJP of every ``*_per`` and ``*_mode`` decomposition and
  reconstruction for ndim 1/2/3, haar/db2/db4/db6, every non-periodic mode,
  with and without ``batch_axis``, and the multi-hop halo (db6 at a level
  whose block is shorter than L - 2): float32 within 1e-5 of the max
  against JAX, float64 within 1e-9 of the max against the port's
  single-device transforms;
- the TailedLeaf structure (which tails are None) equal to the reference's;
- the eager errors, type and message (the package name aside);
- the exchange counter: L - 2 elements a row across each block boundary a
  level, never a block;
- the gradient cores ``sharded_coeff_grads_{per,mode}`` on the same linear
  model in both packages;
- two gloo processes, each owning half of the ring, reproducing the
  one-process mesh.

The JAX side is computed once, in a module-scoped fixture (each sharded
graph compiles once)."""

import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wam_tpu.parallel as jpar
import wam_tpu_torch.parallel as tpar
from wam_tpu_torch.parallel import halo as thalo
from wam_tpu_torch.parallel.tree import tree_leaves
from wam_tpu_torch.wavelets import periodized as tper
from wam_tpu_torch.wavelets import transform as twt

# the suite runs in several pytest-xdist worker processes at once: one
# intra-op thread a process keeps them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# (ndim, shape, shards, wavelet, mode, level, batch_axis); "periodization" = the _per family
CASES = [
    (1, (2, 256), 4, "haar", "symmetric", 3, False),
    (1, (2, 256), 4, "db2", "reflect", 2, False),
    (1, (4, 256), 4, "db4", "zero", 2, True),
    (1, (2, 512), 8, "db6", "constant", 3, False),
    (1, (2, 128), 8, "db6", "periodization", 3, False),  # level-3 block 2 < L-2: 5 hops
    (1, (4, 256), 4, "db2", "periodization", 2, True),
    (2, (2, 3, 64, 20), 4, "db2", "reflect", 2, False),
    (2, (4, 64, 20), 2, "db4", "symmetric", 2, True),
    (2, (2, 64, 32), 4, "haar", "periodization", 2, True),
    (3, (2, 32, 8, 6), 2, "db2", "symmetric", 2, False),
    (3, (4, 32, 6, 6), 2, "haar", "zero", 2, True),
    (3, (2, 32, 8, 8), 2, "db2", "periodization", 2, False),
]
IDS = [f"{c[0]}d-{c[3]}-{c[4]}-J{c[5]}{'-batch' if c[6] else ''}" for c in CASES]


def _input(case, dtype=np.float32):
    return np.random.default_rng(CASES.index(case)).standard_normal(case[1]).astype(dtype)


def _jmesh(k, batch):
    devs = jax.devices()[: k * (2 if batch else 1)]
    return jpar.make_mesh({"data": k, "batch": 2} if batch else {"data": k}, devs)


def _tmesh(k, batch):
    return tpar.make_mesh({"data": k, "batch": 2} if batch else {"data": k},
                          ["cpu"] * (k * (2 if batch else 1)))


def _fns(pkg, case, mesh):
    ndim, _, _, wavelet, mode, level, batch = case
    ba = "batch" if batch else None
    suffix = {1: "", 2: "2", 3: "3"}[ndim]
    if mode == "periodization":
        dec = getattr(pkg, f"sharded_wavedec{suffix}_per")(mesh, wavelet, level, batch_axis=ba)
        rec = getattr(pkg, f"sharded_waverec{suffix}_per")(mesh, wavelet, batch_axis=ba)
    else:
        dec = getattr(pkg, f"sharded_wavedec{suffix}_mode")(mesh, wavelet, level, mode,
                                                          batch_axis=ba)
        rec = getattr(pkg, f"sharded_waverec{suffix}_mode")(mesh, wavelet, batch_axis=ba)
    return dec, rec


def _cotangent(tree, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(np.shape(t)).astype(np.float32) for t in tree]


def _jax_case(case):
    """The reference's gathered coefficients, reconstruction, the VJP of the
    gathered decomposition at a seeded cotangent and the VJP of the
    reconstruction at another, all as numpy."""
    ndim, _, k, _, mode, _, batch = case
    mesh = _jmesh(k, batch)
    dec, rec = _fns(jpar, case, mesh)
    x = jnp.asarray(_input(case))
    if mode == "periodization":
        gather = lambda cs: cs  # noqa: E731
        signal = lambda r: r  # noqa: E731
    else:
        gather = lambda cs: jpar.gather_coeffs(cs, ndim)  # noqa: E731
        signal = lambda r: jpar.gather_leaf(r, -ndim)  # noqa: E731
    flat = lambda cs: jax.tree_util.tree_leaves(gather(cs))  # noqa: E731
    leaves, vjp = jax.vjp(lambda v: flat(dec(v)), x)
    ct = _cotangent(leaves, 1)
    (gx,) = vjp([jnp.asarray(c) for c in ct])
    cs = dec(x)
    r, vjp_r = jax.vjp(lambda c: signal(rec(c)), cs)
    ct_r = _cotangent([r], 2)[0]
    (g_cs,) = vjp_r(jnp.asarray(ct_r))
    tails = ([None] * len(jax.tree_util.tree_leaves(cs)) if mode == "periodization"
             else [leaf.tail is None for leaf in _tailed_leaves(cs)])
    return {"leaves": [np.asarray(t) for t in leaves], "gx": np.asarray(gx),
            "rec": np.asarray(r), "g_cs": [np.asarray(t) for t in flat(g_cs)],
            "ct": ct, "ct_r": ct_r, "none_tails": tails}


def _tailed_leaves(cs):
    out = []
    for c in cs:
        if hasattr(c, "core"):
            out.append(c)
        elif isinstance(c, dict):
            out.extend(c[k] for k in sorted(c))
        else:
            out.extend(c)
    return out


@pytest.fixture(scope="module")
def jref():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (tests/conftest.py)")
    return {i: _jax_case(c) for i, c in enumerate(CASES)}


def _port_gather(case, cs):
    if case[4] == "periodization":
        return [t for c in cs for t in _leaves_of(c, lambda s: s.gather())]
    return tree_leaves(tpar.gather_coeffs(cs, case[0]))


def _leaves_of(c, fn):
    if isinstance(c, tuple):
        return [fn(f) for f in c]
    if isinstance(c, dict):
        return [fn(c[k]) for k in c]
    return [fn(c)]


def _port_signal(case, r):
    return r.gather() if case[4] == "periodization" else tpar.gather_leaf(r, -case[0])


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs {err:.3e} > {tol} x {scale:.3e}"


def _port_run(case, x, ct, ct_r):
    """Forward, VJP of the gathered decomposition (at ``ct``), the
    reconstruction and its VJP with respect to every coefficient (at
    ``ct_r``), gathered, on the port."""
    ndim, _, k, _, mode, _, batch = case
    dec, rec = _fns(tpar, case, _tmesh(k, batch))
    x = x.clone().requires_grad_(True)
    leaves = _port_gather(case, dec(x))
    loss = sum((t * torch.as_tensor(c, dtype=t.dtype)).sum() for t, c in zip(leaves, ct))
    (gx,) = torch.autograd.grad(loss, [x])
    with torch.no_grad():
        cs = dec(x)
    blocks = [t.requires_grad_(True) for t in tree_leaves(cs)]
    r = _port_signal(case, rec(cs))
    g_blocks = torch.autograd.grad((r * torch.as_tensor(ct_r, dtype=r.dtype)).sum(), blocks)
    it = iter(g_blocks)
    from wam_tpu_torch.parallel.tree import tree_map

    g_cs = tree_map(lambda _: next(it), cs)
    return leaves, gx, r, _port_gather(case, g_cs), cs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_transforms_match_the_reference(jref, case):
    """Float32: coefficients, the decomposition's VJP, the reconstruction
    and its VJP against JAX within 1e-5 of the max; the None tails equal."""
    want = jref[CASES.index(case)]
    leaves, gx, r, g_cs, cs = _port_run(case, torch.from_numpy(_input(case)), want["ct"],
                                        want["ct_r"])
    assert len(leaves) == len(want["leaves"])
    for i, (g, w) in enumerate(zip(leaves, want["leaves"])):
        _close(g, w, 1e-5, f"leaf {i}")
    _close(gx, want["gx"], 1e-5, "decomposition VJP")
    _close(r, want["rec"], 1e-5, "reconstruction")
    for i, (g, w) in enumerate(zip(g_cs, want["g_cs"])):
        _close(g, w, 1e-5, f"reconstruction VJP leaf {i}")
    if case[4] != "periodization":
        assert [leaf.tail is None for leaf in _tailed_leaves(cs)] == want["none_tails"]


def _single_device(case, x):
    ndim, _, _, wavelet, mode, level, _ = case
    if mode == "periodization":
        dec = {1: tper.wavedec_per, 2: tper.wavedec2_per, 3: tper.wavedec3_per}[ndim]
        rec = {1: tper.waverec_per, 2: tper.waverec2_per, 3: tper.waverec3_per}[ndim]
        return dec(x, wavelet, level), lambda cs: rec(cs, wavelet)
    if ndim == 1:
        return twt.wavedec(x, wavelet, level, mode), lambda cs: twt.waverec(cs, wavelet)
    if ndim == 2:
        return (twt.wavedec2(x, wavelet, level, mode, impl="conv"),
                lambda cs: twt.waverec2(cs, wavelet, impl="conv"))
    return twt.wavedec3(x, wavelet, level, mode), lambda cs: twt.waverec3(cs, wavelet)


def _ordered(case, coeffs):
    """Single-device coefficient leaves in `_port_gather`'s order."""
    out = []
    for c in coeffs:
        out.extend(_leaves_of(c, lambda t: t))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_transforms_float64_match_single_device(case):
    """Float64: the sharded forward, reconstruction and both VJPs against
    the port's single-device transforms within 1e-9 of the max."""
    x = torch.from_numpy(_input(case, np.float64))
    cs_single, rec_single = _single_device(case, x.clone().requires_grad_(True))
    flat = _ordered(case, cs_single)
    rng = np.random.default_rng(5)
    ct = [rng.standard_normal(tuple(t.shape)) for t in flat]
    ct_r = rng.standard_normal(tuple(x.shape))
    leaves, gx, r, g_cs, _ = _port_run(case, x, ct, ct_r)
    xs = x.clone().requires_grad_(True)
    want_leaves = _ordered(case, _single_device(case, xs)[0])
    loss = sum((t * torch.as_tensor(c)).sum() for t, c in zip(want_leaves, ct))
    (want_gx,) = torch.autograd.grad(loss, [xs])
    with torch.no_grad():
        coeffs = _single_device(case, x)[0]
    req = [t.clone().requires_grad_(True) for t in _ordered(case, coeffs)]
    it = iter(req)
    rebuilt = [type(c)(*(next(it) for _ in c)) if isinstance(c, tuple)
               else {k: next(it) for k in c} if isinstance(c, dict) else next(it)
               for c in coeffs]
    want_r = rec_single(rebuilt)
    want_g = torch.autograd.grad((want_r * torch.as_tensor(ct_r)).sum(), req)
    for i, (g, w) in enumerate(zip(leaves, want_leaves)):
        _close(g, w.detach().numpy(), 1e-9, f"leaf {i}")
    _close(gx, want_gx.numpy(), 1e-9, "decomposition VJP")
    _close(r, want_r.detach().numpy(), 1e-9, "reconstruction")
    for i, (g, w) in enumerate(zip(g_cs, want_g)):
        _close(g, w.numpy(), 1e-9, f"reconstruction VJP leaf {i}")


def _message(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value).replace("wam_tpu_torch", "wam_tpu")


def test_eager_errors_match_the_reference():
    """The decompositions' and reconstructions' eager checks raise the
    reference's exception type and message (package name aside)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    jm, tm = _jmesh(8, False), _tmesh(8, False)
    jb, tb = _jmesh(4, True), _tmesh(4, True)
    x_short = np.zeros((2, 96), np.float32)  # level-2 core 48 not divisible by 16
    x_tiny = np.zeros((2, 64), np.float32)  # db4 level-1 block 8 >= L, level 2: 4 < 8
    x_odd = np.zeros((3, 256), np.float32)  # 3 rows over batch=2
    calls = [
        lambda p, m, b: p.sharded_wavedec_mode(m, "db4", 2, "periodic"),
        lambda p, m, b: p.sharded_wavedec2_mode(m, "db4", 2, "periodization"),
        lambda p, m, b: p.sharded_wavedec3_mode(m, "db4", 2, "wrap"),
        lambda p, m, b: p.sharded_wavedec_mode(m, "haar", 3)(x_short),
        lambda p, m, b: p.sharded_wavedec_mode(m, "db4", 2)(x_tiny),
        lambda p, m, b: p.sharded_wavedec_mode(b, "db2", 2, batch_axis="batch")(x_odd),
    ]
    for i, call in enumerate(calls):
        want = _message(lambda: call(jpar, jm, jb))
        got = _message(lambda: call(tpar, tm, tb))
        assert got == want, (i, got, want)
    # a reconstruction of leaves whose tails are too short for the halo
    x = np.random.default_rng(0).standard_normal((2, 256)).astype(np.float32)
    jcs = jpar.sharded_wavedec_mode(jm, "db4", 2)(jnp.asarray(x))
    tcs = tpar.sharded_wavedec_mode(tm, "db4", 2)(torch.from_numpy(x))
    jcut = [jpar.TailedLeaf(c.core, c.tail[..., :1]) for c in jcs]
    tcut = [tpar.TailedLeaf(c.core, c.tail[..., :1]) for c in tcs]
    assert (_message(lambda: tpar.sharded_waverec_mode(tm, "db4")(tcut))
            == _message(lambda: jpar.sharded_waverec_mode(jm, "db4")(jcut)))


@pytest.mark.parametrize("ndim,shape,wavelet,mode,boundaries", [
    (1, (2, 1024), "db4", "symmetric", 7),
    (1, (2, 1024), "db4", "periodization", 8),
    (2, (2, 3, 64, 16), "db2", "reflect", 7),
    (2, (2, 64, 16), "db2", "periodization", 8),
    (3, (2, 64, 8, 6), "db2", "symmetric", 7),
    (1, (2, 1024), "haar", "symmetric", 0),
])
def test_halo_counter_moves_l_minus_2_a_row_a_boundary(ndim, shape, wavelet, mode, boundaries):
    """A decomposition level moves exactly L - 2 elements a row across each
    block boundary (the periodized ring wraps: 8 boundaries on 8 shards; the
    modes' shard 0 builds its own extension: 7), never a block. A row is a
    line along the sharded axis: the leading dims times the unsharded axes
    as the sharded step sees them (the periodized level transforms the
    sharded axis first; the modes' transform the others first, into 2 or 4
    subbands)."""
    k, level = 8, 2
    L = {"haar": 2, "db2": 4, "db4": 8}[wavelet]
    mesh = _tmesh(k, False)
    suffix = {1: "", 2: "2", 3: "3"}[ndim]
    if mode == "periodization":
        dec = getattr(tpar, f"sharded_wavedec{suffix}_per")(mesh, wavelet, level)
    else:
        dec = getattr(tpar, f"sharded_wavedec{suffix}_mode")(mesh, wavelet, level, mode)
    thalo.reset_halo_elements()
    dec(torch.randn(shape, dtype=torch.float64))
    rows = math.prod(shape[:-ndim])
    other, n, want = list(shape[len(shape) - ndim + 1:]), shape[-ndim], 0
    for _ in range(level):
        if mode == "periodization":
            row_elems = rows * math.prod(other)
            other = [o // 2 for o in other]
        else:
            other = [(o + L - 1) // 2 for o in other]
            row_elems = rows * math.prod(other) * 2 ** (ndim - 1)
        assert L - 2 < n // k  # one hop: less than a block
        want += boundaries * (L - 2) * row_elems
        n //= 2
    assert thalo.halo_elements() == want, (thalo.halo_elements(), want)


def _linear_models(shape, n_classes=5, seed=3):
    fan_in = int(np.prod(shape[1:]))  # O(1) pre-activations: tanh stays unsaturated
    w = (np.random.default_rng(seed).standard_normal((fan_in, n_classes))
         / np.sqrt(fan_in)).astype(np.float32)

    def jmodel(x):
        return jnp.tanh(x.reshape(x.shape[0], -1) @ jnp.asarray(w))

    def tmodel(x):
        return torch.tanh(x.reshape(x.shape[0], -1) @ torch.as_tensor(w, dtype=x.dtype))

    return jmodel, tmodel


@pytest.mark.parametrize("ndim,shape,wavelet,mode", [
    (1, (2, 256), "db2", "symmetric"),
    (2, (2, 64, 16), "db2", "reflect"),
    (3, (2, 32, 6, 6), "haar", "symmetric"),
    (1, (2, 256), "db4", "periodization"),
])
def test_coeff_grads_cores_match_the_reference(ndim, shape, wavelet, mode):
    """`sharded_coeff_grads_{per,mode}` on the same tanh-linear model in
    both packages, labelled and y=None: gathered gradients within 1e-5 of
    the max; fused and split equal."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    jmodel, tmodel = _linear_models(shape)
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    y = np.array([1, 3], np.int32)
    jm, tm = _jmesh(4, False), _tmesh(4, False)
    if mode == "periodization":
        jstep = jpar.sharded_coeff_grads_per(jm, wavelet, 2, jmodel, ndim=ndim)
        tstep = tpar.sharded_coeff_grads_per(tm, wavelet, 2, tmodel, ndim=ndim)
        jg = lambda g: g  # noqa: E731
        tg = lambda g: [t for c in g for t in _leaves_of(c, lambda s: s.gather())]  # noqa: E731
    else:
        jstep = jpar.sharded_coeff_grads_mode(jm, wavelet, 2, jmodel, mode, ndim=ndim)
        tstep = tpar.sharded_coeff_grads_mode(tm, wavelet, 2, tmodel, mode, ndim=ndim)
        split = tpar.sharded_coeff_grads_mode(tm, wavelet, 2, tmodel, mode, ndim=ndim,
                                              fused=False)
        jg = lambda g: jpar.gather_coeffs(g, ndim)  # noqa: E731
        tg = lambda g: tree_leaves(tpar.gather_coeffs(g, ndim))  # noqa: E731
        a = tg(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        b = tg(split(torch.from_numpy(x), torch.from_numpy(y)))
        assert all(torch.equal(p, q) for p, q in zip(a, b))
    for yy in (y, None):
        want = jax.tree_util.tree_leaves(jg(jstep(jnp.asarray(x), None if yy is None
                                                  else jnp.asarray(yy))))
        got = tg(tstep(torch.from_numpy(x), None if yy is None else torch.from_numpy(yy)))
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, np.asarray(w), 1e-5, f"grads leaf {i} (y={yy})")


WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    import numpy as np
    import torch
    import wam_tpu_torch.parallel as tpar
    from wam_tpu_torch.parallel import halo
    from wam_tpu_torch.parallel.tree import tree_leaves

    pid = int(sys.argv[1])
    tpar.init_distributed({coord!r}, 2, pid, initialization_timeout=60, device="cpu")
    case = np.load({case!r})
    x, y, w, z = (torch.from_numpy(case[k]) for k in ("x", "y", "w", "z"))
    mesh = tpar.hybrid_mesh({{"data": 4}}, dcn_axis="data", devices=["cpu"] * 2)
    assert mesh.process_ids is not None and halo.Ring(mesh).distributed
    model = lambda s: torch.tanh(s.reshape(s.shape[0], -1) @ w)
    out = {{}}
    halo.reset_halo_elements()
    cs = tpar.sharded_wavedec_mode(mesh, "db4", 2)(x)
    out["dec"] = tree_leaves(tpar.gather_coeffs(cs))
    out["rec"] = [tpar.gather_leaf(tpar.sharded_waverec_mode(mesh, "db4")(cs))]
    out["per"] = [c.gather() for c in tpar.sharded_wavedec_per(mesh, "db6", 3)(x)]
    g = tpar.sharded_coeff_grads_mode(mesh, "db4", 2, model)(x, y)
    out["grads"] = tree_leaves(tpar.gather_coeffs(g))
    sw = tpar.SeqShardedWam(mesh, model, ndim=1, wavelet="db4", level=2)
    out["smooth"] = tree_leaves(sw.smoothgrad(x, y, n_samples=2, stdev_spread=0.1, noise=z))
    flat = [t.detach().numpy() for k in sorted(out) for t in out[k]]
    np.savez({out!r} + f".{{pid}}.npz", *flat)
    np.save({out!r} + f".{{pid}}.moved.npy", np.array(halo.halo_elements()))
    print(f"WORKER{{pid}}_OK", flush=True)
""")


def test_two_gloo_processes_reproduce_the_one_process_mesh(tmp_path):
    """A ring of 4 blocks over two gloo processes (2 blocks each, the ring
    steps across them through `_RingStep`'s isend/irecv): the mode and
    periodized decompositions (db6 J=3: multi-hop), the reconstruction, the
    gradient core and SeqShardedWam SmoothGrad equal the one-process mesh's
    on both ranks, and the two ranks together count the one-process mesh's
    halo elements."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 256))
    y = np.array([1, 3])
    w = rng.standard_normal((256, 5))
    z = rng.standard_normal((2, 2, 256))
    case = tmp_path / "case.npz"
    np.savez(case, x=x, y=y, w=w, z=z)
    mesh = tpar.make_mesh({"data": 4}, ["cpu"] * 4)
    xt, yt, wt = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w)
    model = lambda s: torch.tanh(s.reshape(s.shape[0], -1) @ wt)  # noqa: E731
    want = {}
    thalo.reset_halo_elements()
    cs = tpar.sharded_wavedec_mode(mesh, "db4", 2)(xt)
    want["dec"] = tree_leaves(tpar.gather_coeffs(cs))
    want["rec"] = [tpar.gather_leaf(tpar.sharded_waverec_mode(mesh, "db4")(cs))]
    want["per"] = [c.gather() for c in tpar.sharded_wavedec_per(mesh, "db6", 3)(xt)]
    want["grads"] = tree_leaves(tpar.gather_coeffs(
        tpar.sharded_coeff_grads_mode(mesh, "db4", 2, model)(xt, yt)))
    sw = tpar.SeqShardedWam(mesh, model, ndim=1, wavelet="db4", level=2)
    want["smooth"] = tree_leaves(sw.smoothgrad(xt, yt, n_samples=2, stdev_spread=0.1,
                                               noise=torch.from_numpy(z)))
    moved = thalo.halo_elements()
    flat_want = [t.detach().numpy() for k in sorted(want) for t in want[k]]
    out = str(tmp_path / "out")
    # a file rendezvous in the test's own directory: no port to lose to
    # another process between choosing it and binding it
    code = WORKER.format(root=str(ROOT), coord=f"file://{tmp_path / 'rendezvous'}",
                         case=str(case), out=out)
    env = {**{k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")},
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}  # as this process
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pid)], cwd=str(ROOT), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    counts = 0
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER{pid}_OK" in log, log[-3000:]
        got = np.load(f"{out}.{pid}.npz")
        arrays = [got[f"arr_{i}"] for i in range(len(got.files))]
        assert len(arrays) == len(flat_want)
        for a, b in zip(arrays, flat_want):
            np.testing.assert_array_equal(a, b)
        counts += int(np.load(f"{out}.{pid}.moved.npy"))
    assert counts == moved, (counts, moved)


BATCH_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    import numpy as np
    import torch
    import wam_tpu_torch.parallel as tpar
    from wam_tpu_torch.parallel import halo
    from wam_tpu_torch.parallel.tree import tree_leaves

    pid = int(sys.argv[1])
    tpar.init_distributed({coord!r}, 2, pid, initialization_timeout=60, device="cpu")
    case = np.load({case!r})
    x, y, w, z = (torch.from_numpy(case[k]) for k in ("x", "y", "w", "z"))
    mesh = tpar.hybrid_mesh({{"batch": 2, "seq": 2}}, dcn_axis="seq", devices=["cpu"] * 2)
    ring = halo.Ring(mesh, "seq", "batch")
    assert ring.distributed and ring.g == 2 and len({{r for row in ring.ranks for r in row}}) == 2
    model = lambda s: torch.tanh(s.reshape(s.shape[0], -1) @ w)
    flat = []
    for mode, chunk in (("symmetric", 1), ("symmetric", 2), ("periodization", 2)):
        sw = tpar.SeqShardedWam(mesh, model, ndim=1, wavelet="db4", level=2, mode=mode,
                                seq_axis="seq", batch_axis="batch")
        out = sw.smoothgrad(x, y, n_samples=2, stdev_spread=0.1, noise=z, sample_chunk=chunk)
        flat += [t.detach().numpy() for t in tree_leaves(out)]
    np.savez({out!r} + f".{{pid}}.npz", *flat)
    print(f"WORKER{{pid}}_OK", flush=True)
""")


def test_batch_axis_on_a_ring_across_two_gloo_processes():
    """``batch_axis`` on a {batch: 2, seq: 2} mesh whose sequence ring spans
    two gloo processes (each rank holds one seq block of both row groups):
    SeqShardedWam SmoothGrad (the mode transforms one sample and two a
    step, and the periodized ones) equals the one-process mesh's within
    1e-6 of the max on both ranks."""
    import tempfile

    rng = np.random.default_rng(31)
    x = rng.standard_normal((4, 256))
    y = np.array([1, 3, 0, 2])
    w = rng.standard_normal((256, 5))
    z = rng.standard_normal((2, 4, 256))
    mesh = tpar.make_mesh({"batch": 2, "seq": 2}, ["cpu"] * 4)
    wt = torch.from_numpy(w)
    model = lambda s: torch.tanh(s.reshape(s.shape[0], -1) @ wt)  # noqa: E731
    want = []
    for mode, chunk in (("symmetric", 1), ("symmetric", 2), ("periodization", 2)):
        sw = tpar.SeqShardedWam(mesh, model, ndim=1, wavelet="db4", level=2, mode=mode,
                                seq_axis="seq", batch_axis="batch")
        out = sw.smoothgrad(torch.from_numpy(x), torch.from_numpy(y), n_samples=2,
                            stdev_spread=0.1, noise=torch.from_numpy(z), sample_chunk=chunk)
        want += [t.detach().numpy() for t in tree_leaves(out)]
    with tempfile.TemporaryDirectory() as tmp:
        case = os.path.join(tmp, "case.npz")
        np.savez(case, x=x, y=y, w=w, z=z)
        out = os.path.join(tmp, "out")
        code = BATCH_WORKER.format(root=str(ROOT), coord=f"file://{tmp}/rendezvous", case=case,
                                   out=out)
        env = {**{k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")},
               "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}  # as this process
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        procs = [subprocess.Popen([sys.executable, "-c", code, str(pid)], cwd=str(ROOT), env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for pid in (0, 1)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=120)[0])
        finally:
            for p in procs:
                p.kill()
        for pid, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0 and f"WORKER{pid}_OK" in log, log[-3000:]
            got = np.load(f"{out}.{pid}.npz")
            arrays = [got[f"arr_{i}"] for i in range(len(got.files))]
            assert len(arrays) == len(want)
            for a, b in zip(arrays, want):
                assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
