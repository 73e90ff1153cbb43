"""The probe kernels P1-P3 (``ops/cuda/probes.py``) and their tools vs the
JAX package's probe tools: the plain PyTorch versions (which the CPU runs)
against the tools' Pallas kernels in interpret mode, with the tools' K
(and S, C) lowered; ``fast_exp`` against the JAX ``fast_exp``; every scan
variant against float64 ``cumprod``; the port's tools end to end on the
CPU at small sizes."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import triangle_splatting_tpu.utils.jax_setup as jax_setup
from triangle_splatting_tpu_torch.ops.cuda import probes as TP
from triangle_splatting_tpu_torch.tools import exp_probe as t_exp
from triangle_splatting_tpu_torch.tools import scan_probe as t_scan
from triangle_splatting_tpu_torch.tools import vpu_probe as t_vpu
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOOLS = Path(__file__).resolve().parent.parent / "tools"
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
K_TEST = 8


@functools.lru_cache(maxsize=None)
def jax_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module, imported without
    its ``setup()`` (which would turn on the persistent compilation cache
    of the whole test process)."""
    real = jax_setup.setup
    jax_setup.setup = lambda *a, **kw: None
    try:
        spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", TOOLS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax_setup.setup = real
    return mod


def interpret(kernel, x: np.ndarray) -> np.ndarray:
    """One tool kernel through ``pl.pallas_call(..., interpret=True)`` on x."""
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))


def block(rows, cols, lo, hi, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, size=(rows, cols)).astype(np.float32)


def rel(got, want):
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("op", TP.VPU_OPS)
def test_vpu_probe_plain_matches_jax(op, dtype, monkeypatch):
    mod = jax_tool("vpu_probe")
    monkeypatch.setattr(mod, "K", K_TEST)
    x = block(16, 128, -1.5, 1.5)     # min3 moves only the negative values
    want = interpret(functools.partial(mod._kernel, op=op, dtype=JAX_DTYPES[dtype]), x)
    before = TP.vpu_probe.launches
    got = TP.vpu_probe(torch.as_tensor(x), op, dtype, K_TEST).numpy()
    assert TP.vpu_probe.launches == before          # CPU: the plain version
    if dtype == torch.float32 and op in ("mul", "min3"):
        # the same correctly rounded products, sums and minima in one order
        np.testing.assert_array_equal(got, want)
    elif dtype == torch.float32:
        # fma: XLA contracts v * c + c into one rounding, PyTorch rounds
        # twice (an ulp a pass, measured 1.1e-7 after 8); exp: the two
        # frameworks' exp differ by an ulp, and the chain's derivative is
        # 1e-6, so it does not grow: rel 1e-6
        assert rel(got, want) <= 1e-6
    else:
        # bfloat16 rounds each step to 8 bits; the two frameworks' exp may
        # round an ulp (2^-8) apart
        assert rel(got, want) <= 2 ** -7
    assert np.isfinite(got).all()
    if dtype == torch.float32:       # in bfloat16 the multiplier is exactly 1
        assert not np.array_equal(got, x)


# ---------------------------------------------------------------------------
# P2
# ---------------------------------------------------------------------------

def test_fast_exp_matches_jax():
    mod = jax_tool("exp_probe")
    t = np.linspace(0.0, 44.0, 8192, dtype=np.float32)
    want = np.asarray(mod.fast_exp(jnp.asarray(-t)))
    got = TP.fast_exp(torch.as_tensor(-t)).numpy()
    # the same float32 products, sums, floor and exponent bitcast
    np.testing.assert_array_equal(got, want)
    ref = np.exp(-t.astype(np.float64))
    assert float(np.max(np.abs(got - ref) / ref)) <= 1e-5   # the polynomial's own error


@pytest.mark.parametrize("op", ["mul8", "exp", "fastexp"])
def test_exp_probe_plain_matches_jax(op, monkeypatch):
    mod = jax_tool("exp_probe")
    monkeypatch.setattr(mod, "K", K_TEST)
    x = block(16, 128, 0.5, 1.5, seed=1)
    want = interpret(functools.partial(mod._kernel, op=op), x)
    got = TP.exp_probe(torch.as_tensor(x), op, K_TEST).numpy()
    if op == "exp":
        assert rel(got, want) <= 1e-6                  # an ulp of exp, not grown
    elif op == "mul8":
        # XLA folds the eight constant products into one (v * c^8, one
        # rounding a pass against eight here): up to ~4 ulp a pass, 2.7e-6
        # measured after 8 passes
        assert rel(got, want) <= 1e-5
    else:
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()


def test_exp_probe_intrinsic_plain_is_exp():
    """"exp_intrinsic" has no JAX twin: its plain version is torch.exp."""
    x = torch.as_tensor(block(16, 128, 0.5, 1.5, seed=2))
    assert torch.equal(TP.exp_probe(x, "exp_intrinsic", 4), TP.exp_probe(x, "exp", 4))


# ---------------------------------------------------------------------------
# P3
# ---------------------------------------------------------------------------

SCAN_S, SCAN_C = 64, 128


@pytest.mark.parametrize("variant", TP.SCAN_VARIANTS)
def test_scan_probe_plain_matches_jax(variant, monkeypatch):
    mod = jax_tool("scan_probe")
    monkeypatch.setattr(mod, "K", 4)
    monkeypatch.setattr(mod, "S", SCAN_S)
    x = block(SCAN_S, SCAN_C, 0.9, 1.0, seed=3)
    want = interpret(functools.partial(mod._kernel, fn=mod.VARIANTS[variant]), x)
    got = TP.scan_probe(torch.as_tensor(x), variant, 4).numpy()
    if variant == "mxu_log":
        # a float32 matrix product of logs: the two frameworks sum the 64
        # terms in other orders
        assert rel(got, want) <= 1e-5
    else:
        # the same products in the same tree order
        np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.9 and got.max() <= 1.0


@pytest.mark.parametrize("variant", TP.SCAN_VARIANTS)
def test_scan_probe_plain_matches_float64_cumprod(variant):
    """One unclipped scan of the tool's check input (256 rows) against
    float64 cumprod. A float32 product of 256 factors in [0.9, 1] carries
    ~256 roundings: 1.1-1.5e-6 measured for every order the kernels and the
    JAX tool use, so rel 2e-6; mxu_log sums 256 float32 logs and
    exponentiates: 1.2e-5 measured, rel 2e-5."""
    x = torch.linspace(0.9, 1.0, 256 * SCAN_C).reshape(256, SCAN_C)
    ref = torch.cumprod(x.double(), dim=0)
    got = TP.scan_probe(x, variant, k=1, clip=False).double()
    err = float(((got - ref).abs() / ref).max())
    assert err <= (2e-5 if variant == "mxu_log" else 2e-6), err


@pytest.mark.parametrize("k", [1, 2, 3])
def test_scan_hs_register_layout_keeps_the_products(k):
    """The "hs" kernel's register layout (``prefix_hs_lanes``: lanes of 8
    rows, passes below 8 within a lane and from the previous lane, larger
    ones a whole lane back) against the plain "hs" passes over the 256
    rows: bit for bit, so the layout keeps every product and its order.
    K = 1 unclipped on [0.9, 1]; K = 2 and 3 clipped on [0.999999, 1],
    where the first 100 rows stay above the clip's 0.9 (below it the clip
    would hide a wrong product)."""
    lo = 0.9 if k == 1 else 0.999999
    x = torch.as_tensor(block(256, SCAN_C, lo, 1.0, seed=7))
    v = x
    for _ in range(k):
        v = TP.prefix_hs_lanes(v)
        if k > 1:
            v = torch.clamp(v, 0.9, 1.0)
    want = TP.scan_probe_plain(x, "hs", k, clip=k > 1)
    assert torch.equal(v, want) and not torch.equal(want, x)
    if k > 1:
        assert bool((want[:100] > 0.9).all())


def test_scan_probe_rejects_unknown_variant():
    with pytest.raises(ValueError):
        TP.scan_probe(torch.ones((256, 128)), "hs_sideways")


# ---------------------------------------------------------------------------
# the tools end to end (CPU: the plain versions)
# ---------------------------------------------------------------------------

def test_tools_run_on_cpu(capsys):
    v = t_vpu.main(["--k", "3", "--r", "8", "--c", "128", "--device", "cpu"])
    e = t_exp.main(["--k", "3", "--r", "8", "--c", "128", "--device", "cpu"])
    s = t_scan.main(["--k", "2", "--c", "128", "--device", "cpu"])
    assert [(r["op"], r["dtype"]) for r in v] == [(op, d) for op in TP.VPU_OPS
                                                  for d in ("float32", "bfloat16")]
    assert [r["op"] for r in e] == list(TP.EXP_OPS)
    assert list(s["check"]) == list(TP.SCAN_VARIANTS)
    assert max(s["check"].values()) <= 2e-5
    out = capsys.readouterr().out
    assert "T elem-ops/s" in out and "ps/elem" in out and "ns/scan" in out
    assert "fast_exp max rel err" in out
    assert all(r["ms"] > 0 for r in v + e + s["runs"])
    # the tools' defaults are the JAX tools' shapes
    assert (t_vpu.R, t_vpu.C, t_vpu.K) == (512, 1024, 65536)
    assert (t_exp.R, t_exp.C, t_exp.K) == (512, 1024, 16384)
    assert (t_scan.S, t_scan.C, t_scan.K) == (256, 1024, 2048)


def test_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        t_vpu.run("mul", torch.float32, k=1, r=8, c=128)
