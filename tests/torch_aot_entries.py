"""The compiled entries' fixtures (`tests/test_torch_aot_entries_*.py`): a
toy explainer of each kind in the port and in the reference, on the same
weights, and a child-process drive of the port's entry over a warm
compiled-step cache.

    python tests/torch_aot_entries.py KIND KERNEL.npy KEY OUT.npz

builds the port's explainer of KIND ("1d", "3d" or "video") on the toy
model with the kernel in KERNEL.npy, calls ``serve_entry(aot_key=KEY)`` on
the kind's inputs on the CPU, writes the result's leaves to OUT.npz and
prints one JSON line: the first-call compiles and the programs' status."""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SR, NFFT, NMELS, WLEN = 8000, 128, 16, 2048
TAPS, CLASSES = 5, 4
KW = {
    "1d": dict(wavelet="db2", J=3, n_mels=NMELS, n_fft=NFFT, sample_rate=SR),
    "3d": dict(wavelet="db2", J=2),
    "video": dict(levels=(2, 1)),
}
EST = dict(method="integratedgrad", n_samples=4, sample_batch_size=2)
NDIM = {"1d": 2, "3d": 3, "video": 3}


def kernel_shape(kind: str) -> tuple:
    return (CLASSES, 1) + (TAPS,) * NDIM[kind]


def inputs(kind: str):
    """(x, y) numpy inputs of the kind's entry."""
    rng = np.random.default_rng(11)
    shape = {"1d": (2, WLEN), "3d": (2, 1, 10, 10, 10), "video": (2, 1, 8, 16, 16)}[kind]
    return rng.standard_normal(shape).astype(np.float32), np.array([0, 1])


def _wrap(kind: str, fn):
    """The toy model (B, S...) -> logits behind the kind's input layout:
    mel (N, 1, T, M), volumes (B, 1, D, H, W), clips (B, 1, T, H, W)."""
    return lambda t: fn(t[:, 0])


def port_explainer(kind: str, kern: np.ndarray, **over):
    import wam_tpu_torch as wtt
    from wam_tpu_torch.models.toy import toy_conv_model

    fn = _wrap(kind, toy_conv_model(kern, ndim=NDIM[kind], classes=CLASSES, device="cpu"))
    cls = {"1d": wtt.WaveletAttribution1D, "3d": wtt.WaveletAttribution3D,
           "video": wtt.WaveletAttributionVideo}[kind]
    return cls(fn, device="cpu", **{**KW[kind], **EST, **over})


def reference_explainer(kind: str, key, **over):
    """The reference's explainer on ``toy_conv_model(key)``, whose kernel is
    `jax.random.normal(key, kernel_shape) * 0.3`."""
    import wam_tpu as wt
    from wam_tpu.models.toy import toy_conv_model
    from wam_tpu.xattr.video import WaveletAttributionVideo

    fn = _wrap(kind, toy_conv_model(key, ndim=NDIM[kind], classes=CLASSES, taps=TAPS))
    cls = {"1d": wt.WaveletAttribution1D, "3d": wt.WaveletAttribution3D,
           "video": WaveletAttributionVideo}[kind]
    return cls(fn, **{**KW[kind], **EST, **over})


def leaves(out) -> list:
    """The leaves of an entry's result, in order."""
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in leaves(o)]
    return [np.asarray(out.detach().cpu().numpy() if hasattr(out, "detach") else out)]


def programs(entry) -> list:
    """(key, status, compiles) of each program an entry made."""
    return [(f.key, f.aot_status, f.compiles)
            for d in entry.wam_aot_fns for f in d.fns.values()]


def child(kind: str, kern_path: str, key: str, out_path: str) -> dict:
    import torch

    torch.set_num_threads(1)
    m = port_explainer(kind, np.load(kern_path))
    entry = m.serve_entry(aot_key=key)
    x, y = inputs(kind)
    out = entry(torch.from_numpy(x), torch.from_numpy(y))
    np.savez(out_path, *leaves(out))
    progs = programs(entry)
    return {"compiles": sum(c for _, _, c in progs), "status": [s for _, s, _ in progs]}


def _close(got, want, tol, tag):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), (tag, got.shape, want.shape)
    peak = np.abs(want).max()
    assert peak > 0, tag
    err = np.abs(got - want).max()
    assert err <= tol * peak, (tag, err / peak)


def run_case(kind: str, tmp_path, monkeypatch) -> None:
    """The test of one kind (module docstring of the test files): compiled
    rows against eager (1e-5 of the max: Inductor's kernels sum in another
    order) and against the reference's compiled entry (1e-4 of the max, the
    slices' bound), then a second process at 0 compiles whose rows equal
    the first's (1e-6 of the max)."""
    import subprocess

    import jax
    import jax.numpy as jnp
    import torch
    import torch._inductor.config

    aot = tmp_path / "aot"
    monkeypatch.setenv("WAM_TPU_AOT_CACHE", str(aot))
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "inductor"))
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "inductor" / "triton"))
    monkeypatch.delenv("WAM_TPU_NO_AOT_CACHE", raising=False)
    monkeypatch.setattr(torch._inductor.config, "compile_threads", 1)
    torch._dynamo.reset()
    key = jax.random.PRNGKey(3)
    kern = np.asarray(jax.random.normal(key, kernel_shape(kind), jnp.float32) * 0.3)
    x, y = inputs(kind)
    m = port_explainer(kind, kern)
    eager = leaves(m.serve_entry()(torch.from_numpy(x), torch.from_numpy(y)))
    entry = m.serve_entry(aot_key=f"toy-{kind}")
    assert entry.wam_aot_fns == []
    got = leaves(entry(torch.from_numpy(x), torch.from_numpy(y)))
    progs = programs(entry)
    assert [(s, c) for _, s, c in progs] == [("exported", 1)], progs
    assert len(got) == len(eager)
    for i, (g, e) in enumerate(zip(got, eager)):
        _close(g, e, 1e-5, f"{kind} compiled vs eager, leaf {i}")

    monkeypatch.setenv("WAM_TPU_AOT_CACHE", str(tmp_path / "reference-aot"))
    jm = reference_explainer(kind, key)
    want = leaves(jm.serve_entry(aot_key=f"toy-{kind}")(jnp.asarray(x), jnp.asarray(y)))
    monkeypatch.setenv("WAM_TPU_AOT_CACHE", str(aot))
    assert len(want) == len(got)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 1e-4, f"{kind} compiled vs the reference, leaf {i}")

    np.save(tmp_path / "kern.npy", kern)
    env = {**os.environ, "WAM_TPU_AOT_CACHE": str(aot), "OMP_NUM_THREADS": "1",
           "TORCHINDUCTOR_CACHE_DIR": str(tmp_path / "inductor2"),
           "TRITON_CACHE_DIR": str(tmp_path / "inductor2" / "triton")}
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), kind, str(tmp_path / "kern.npy"),
         f"toy-{kind}", str(tmp_path / "again.npz")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == {"compiles": 0, "status": ["hit"]}
    again = np.load(tmp_path / "again.npz")
    for i, g in enumerate(got):
        _close(again[f"arr_{i}"], g, 1e-6, f"{kind} second process, leaf {i}")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    print(json.dumps(child(*sys.argv[1:5])))
