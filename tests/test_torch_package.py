"""The port as a package: the card is its default device, and it reads its
own model files, never the JAX package's.

- ``compile_circuit``, ``params_from_numpy``, ``simulate``, ``dc_sweep``,
  ``mc_dc``, ``mc_statistics``, ``pvt_sweep.run_chunked``, ``ac`` and
  ``noise`` without a device raise
  where no CUDA card is present (the message names ``device="cpu"``); with
  ``device="cpu"`` they run on the CPU; ``device="cuda"`` becomes the
  indexed current card.
- ``cedarsim_tpu_torch.models.MODELS_DIR`` and every entry of
  ``MODEL_SEARCH_PATHS`` lie inside ``cedarsim_tpu_torch/``, and its
  ``bsim4.va``, ``vbic.va``, every file of ``models/bsimcmg107/`` and of
  ``va/stdlib/`` are byte for byte the JAX package's (a fix goes into
  both).
- ``cuda_lib.build_library`` keeps the compiler's log beside a library it
  builds, so a library loaded without a compile still reports ptxas's
  registers and spills, and threads that build one library at once run
  the compiler once.
- Every module copied from the JAX package (the modules that need no JAX)
  equals its original but for the import lines, the docstring's "Copy
  of" paragraph and the citations' machine-specific path prefix;
  ``native/symbolic.cpp`` is byte for byte the JAX package's.
- No module of the port, and not ``chip_smoke.py``, imports ``jax`` or
  ``cedarsim_tpu`` (an AST scan of every import).
- ``simulate`` runs ``.ac``, ``.noise``, ``.four`` and ``.meas``;
  ``.save`` and ``.probe`` keep only their nets' columns (the same bits)
  and ``.data`` records its table for ``data_sweep``.
"""

import os

import numpy as np
import pytest
import torch

import cedarsim_tpu_torch as T
from cedarsim_tpu_torch import config, models
from cedarsim_tpu_torch.utils.convert import params_from_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "cedarsim_tpu_torch")


def _rc():
    ckt = T.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(T.VSource, "V1", (vin, ckt.gnd), dict(dc=1.0))
    ckt.add(T.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(T.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    return ckt


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["compile_circuit", "CompiledCircuit",
                                   "params_from_numpy", "simulate",
                                   "dc_sweep", "mc_dc", "mc_statistics",
                                   "pvt_sweep.run_chunked", "ac", "noise"])
def test_no_device_and_no_card_raises(no_card, entry):
    from cedarsim_tpu_torch.analysis import montecarlo, sweeps
    from cedarsim_tpu_torch.benchmarks import pvt_sweep
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if entry == "params_from_numpy":
            params_from_numpy({"g": {"r": np.ones(2)}})
        elif entry == "simulate":
            T.simulate("* rc\nV1 a 0 1\nR1 a 0 1k\n.op\n")
        elif entry == "dc_sweep":
            sweeps.dc_sweep(_rc(), sweeps.Sweep("r1.r", [1e3, 2e3]))
        elif entry == "mc_dc":
            montecarlo.mc_dc(_rc(), 4, {"r1.r": ("rel", 0.1)})
        elif entry == "mc_statistics":
            montecarlo.mc_statistics(T.parse_spice(
                "* mc\nV1 a 0 1\nR1 a 0 {agauss(1k, 100, 1)}\n.op\n"), 2)
        elif entry == "pvt_sweep.run_chunked":
            pvt_sweep.run_chunked(4, 4)
        elif entry == "ac":
            T.ac(_rc(), [1e3])
        elif entry == "noise":
            T.noise(_rc(), "vout", [1e3])
        else:
            getattr(T, entry)(_rc())


def test_cpu_when_asked():
    comp = T.compile_circuit(_rc(), device="cpu")
    assert comp.device == torch.device("cpu")
    op = T.solve_dc(comp)
    assert bool(op.converged) and op.x.device == torch.device("cpu")
    # the capacitor is open at DC: vout follows vin
    assert abs(float(op["vout"]) - 1.0) < 1e-6
    p = params_from_numpy({"g": {"r": np.ones(2)}}, device="cpu")
    assert p["g"]["r"].device == torch.device("cpu")
    assert p["g"]["r"].dtype == torch.float64


def test_cuda_resolves_to_the_indexed_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert config.resolve_device(None) == torch.device("cuda", 0)
    assert config.resolve_device("cuda") == torch.device("cuda", 0)
    assert config.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert config.resolve_device("cpu") == torch.device("cpu")


def test_model_paths_are_the_ports_own():
    def inside(path):
        return os.path.commonpath([os.path.realpath(path),
                                   os.path.realpath(PKG)]) == \
            os.path.realpath(PKG)
    assert inside(models.MODELS_DIR)
    assert models.MODEL_SEARCH_PATHS
    assert all(inside(p) for p in models.MODEL_SEARCH_PATHS)
    assert os.path.isfile(os.path.join(models.MODELS_DIR, "bsim4.va"))


def test_bsim4_copy_equals_the_jax_packages():
    with open(os.path.join(PKG, "models", "bsim4.va"), "rb") as f:
        mine = f.read()
    with open(os.path.join(REPO, "cedarsim_tpu", "models", "bsim4.va"),
              "rb") as f:
        ref = f.read()
    assert mine == ref


#: the directories the port holds byte for byte: the CMC BSIM-CMG 107
#: sources and the Verilog-A standard headers
BYTE_COPY_DIRS = ("models/bsimcmg107", "va/stdlib")
#: single model sources the port holds byte for byte
BYTE_COPY_FILES = ("models/vbic.va",)


@pytest.mark.parametrize("rel", [
    f"{d}/{name}" for d in BYTE_COPY_DIRS
    for name in sorted(os.listdir(os.path.join(REPO, "cedarsim_tpu", d)))]
    + list(BYTE_COPY_FILES))
def test_model_sources_equal_the_jax_packages(rel):
    """Each copied file is byte for byte the JAX package's, and each
    copied directory holds the same files."""
    with open(os.path.join(PKG, rel), "rb") as f:
        mine = f.read()
    with open(os.path.join(REPO, "cedarsim_tpu", rel), "rb") as f:
        assert mine == f.read()
    d = os.path.dirname(rel)
    if d in BYTE_COPY_DIRS:
        assert sorted(os.listdir(os.path.join(PKG, d))) == sorted(
            os.listdir(os.path.join(REPO, "cedarsim_tpu", d)))


def test_native_planner_copy_equals_the_jax_packages():
    with open(os.path.join(PKG, "native", "symbolic.cpp"), "rb") as f:
        mine = f.read()
    with open(os.path.join(REPO, "cedarsim_tpu", "native", "symbolic.cpp"),
              "rb") as f:
        assert mine == f.read()


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return out


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_the_port_imports_no_jax(path):
    """No module of the port, and not ``chip_smoke.py``, imports JAX or the
    JAX package (``cedarsim_tpu``, not even its JAX-free modules)."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib",
                                                   "cedarsim_tpu")]
    assert not bad, bad


def test_build_library_keeps_the_compiler_log(tmp_path, monkeypatch):
    """A library built earlier loads without a compile and still reports
    the log its build printed (ptxas's registers and spills): the log is
    kept beside the shared object.  The compiler here is ``g++`` behind a
    stand-in ``nvcc`` that prints a ptxas-like line."""
    import shutil
    from cedarsim_tpu_torch.ops import cuda_lib
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to stand in for nvcc")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "echo 'ptxas info    : Used 7 registers' >&2\n"
                    "exec g++ \"$@\"\n")
    fake.chmod(0o755)
    src = tmp_path / "k.cpp"
    src.write_text('extern "C" int answer(void) { return 42; }\n')
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path / "build"))
    flags = ("-shared", "-fPIC")
    first = cuda_lib.build_library("k", str(src), flags)
    again = cuda_lib.build_library("k", str(src), flags)
    assert first["seconds"] > 0.0 and again["seconds"] == 0.0
    assert "Used 7 registers" in first["log"]
    assert again["log"] == first["log"]
    assert again["lib"].answer() == 42


def test_build_library_builds_once_across_threads(tmp_path, monkeypatch):
    """Two threads that build the same library at once (two fused plans
    that emit one source) share one compiler run: the second waits for
    the first and loads its library.  The stand-in ``nvcc`` records each
    run and sleeps before ``g++``, so both threads ask before either
    build ends."""
    import shutil
    import threading
    from cedarsim_tpu_torch.ops import cuda_lib
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to stand in for nvcc")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    runs = tmp_path / "runs.txt"
    fake = bindir / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo run >> '{runs}'\n"
                    "sleep 0.5\n"
                    "exec g++ \"$@\"\n")
    fake.chmod(0o755)
    src = tmp_path / "k.cpp"
    src.write_text('extern "C" int answer(void) { return 42; }\n')
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path / "build"))
    out = [None, None]

    def build(i):
        try:
            out[i] = cuda_lib.build_library("k", str(src),
                                            ("-shared", "-fPIC"))
        except BaseException as e:      # re-raised below
            out[i] = e
    threads = [threading.Thread(target=build, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for r in out:
        if isinstance(r, BaseException):
            raise r
    assert runs.read_text().splitlines() == ["run"]
    assert sorted(r["seconds"] > 0.0 for r in out) == [False, True]
    assert all(r["lib"].answer() == 42 for r in out)


#: the port's copies of JAX-free modules of the JAX package
COPIES = ("core/circuit.py", "frontend/parser.py", "frontend/expr.py",
          "frontend/numbers.py", "frontend/touchstone.py",
          "analysis/measure.py", "va/ast.py", "va/diagnostics.py",
          "va/lexer.py", "va/parser.py", "va/preproc.py", "ops/sparse.py",
          "frontend/spectre.py", "frontend/alter.py", "tools/convert.py",
          "utils/export.py", "utils/inspect.py")


@pytest.mark.parametrize("rel", COPIES)
def test_copies_equal_their_originals(rel):
    import re
    with open(os.path.join(PKG, rel)) as f:
        mine = f.read()
    with open(os.path.join(REPO, "cedarsim_tpu", rel)) as f:
        orig = f.read()
    para = re.compile(r"\n\nCopy of ``cedarsim_tpu/" + re.escape(rel)
                      + r"``.*?path prefix\.\n", re.S)
    assert len(para.findall(mine)) == 1
    mine = para.sub("\n", mine)
    mine = re.sub(r"^(\s*)from cedarsim_tpu_torch\.", r"\1from cedarsim_tpu.",
                  mine, flags=re.M)
    orig = re.sub(r"(?<![\w./])/[a-z]+/reference/", "reference/", orig)
    assert mine == orig


def test_simulate_runs_the_ac_noise_and_measure_directives():
    base = ("* rc\nV1 a 0 DC 0 AC 1 SIN(0 1 1meg)\nR1 a b 1k\n"
            "C1 b 0 1n\n")
    out = T.simulate(base + ".ac dec 2 1k 1meg\n.noise v(b) v1 dec 2 1k "
                     "1meg\n.tran 10n 3u\n.four 1meg v(b)\n"
                     ".meas ac g find vm(b) at=1k\n", device="cpu")
    assert {"ac", "noise", "tran", "fourier", "measures"} <= set(out)
    assert out["measures"]["g"] == pytest.approx(1.0, rel=1e-3)
    full = T.simulate(base + ".tran 10n 3u\n", device="cpu")["tran"]
    for card in (".save v(b)", ".probe v(b)", ".data d1 r1 1k 2k\n.enddata"):
        out = T.simulate(base + ".tran 10n 3u\n" + card + "\n", device="cpu")
        sol = out["tran"]
        if card.startswith(".data"):
            # a table is recorded for data_sweep; the run keeps every column
            assert list(T.data_sweep(out["circuit"])) == [
                {"r1": 1000.0}, {"r1": 2000.0}]
            assert sol.store_map is None and sol.xs.shape == full.xs.shape
            continue
        # .save/.probe keep only b, the same bits as the whole state's column
        assert sol.store_map == {"b": 0} and sol.xs.shape[1] == 1
        i = full.compiled.node_names.index("b")
        assert np.array_equal(sol.xs[:, 0], full.xs[:, i])
        with pytest.raises(KeyError, match="not stored"):
            sol["a"]


#: the AD and RF analyses (ROADMAP A16, A17): scanned by
#: ``test_the_port_imports_no_jax`` like every module of the port
AD_RF_MODULES = ("analysis/sensitivity.py", "analysis/pss.py",
                 "analysis/hb.py", "analysis/fragility.py")


def test_the_ad_and_rf_modules_are_scanned_and_exported():
    srcs = _port_sources()
    assert all(os.path.join(PKG, rel) in srcs for rel in AD_RF_MODULES)
    for name in ("pss", "hb", "hb_autonomous", "pac", "pnoise",
                 "oscillator_phase_noise"):
        assert name in T.__all__ and callable(getattr(T, name))


#: the front end's breadth, the tools and the utilities (ROADMAP A19)
A19_MODULES = ("frontend/alter.py", "tools/__init__.py", "tools/convert.py",
               "utils/artifacts.py", "utils/explore.py", "utils/export.py",
               "utils/inspect.py", "utils/profiling.py", "va/reload.py")


def test_the_a19_modules_are_scanned_and_exported():
    """Every A19 module is one that ``test_the_port_imports_no_jax``
    scans; ``data_sweep`` and ``ensure_dynamic`` are exported; and no
    ``NotImplementedError`` of the port names A19 any more."""
    srcs = _port_sources()
    assert all(os.path.join(PKG, rel) in srcs for rel in A19_MODULES)
    for name in ("data_sweep", "ensure_dynamic"):
        assert name in T.__all__ and callable(getattr(T, name))
    for path in srcs:
        with open(path) as f:
            assert "A19" not in f.read() or path.endswith("chip_smoke.py")


def test_the_ad_and_rf_entry_points_run_where_the_circuit_lives():
    """Each takes a compiled circuit, so it runs on the device the circuit
    was compiled on (the card by default; here the CPU, as asked)."""
    from cedarsim_tpu_torch.analysis import fragility, sensitivity
    comp = T.compile_circuit(_rc(), device="cpu")
    val, g = sensitivity.dc_sensitivity(comp, "vout", ["R1.r"])
    assert val.device == g["R1.r"].device == torch.device("cpu")
    assert float(sensitivity.tf(comp, "vout", "V1")["gain"]) == \
        pytest.approx(1.0)
    assert T.pss(comp, 1e-6).converged
    res = T.hb(comp, 1e-6, n_harmonics=2, init="dc")
    assert res.converged and res.samples("vout").shape == (5,)
    rep = fragility.init_fragility(comp, n=4)
    assert rep.n_solutions == 1
