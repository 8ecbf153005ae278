"""The port stands alone: no JAX, no tardis_tpu, and no silent CPU fallback."""

import ast
import copy
from pathlib import Path

import pytest
import torch

from tardis_torch.simulation.base import run_tardis

from tests.test_torch_slice import CONFIG

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "tardis_tpu")


def _port_files():
    return sorted((ROOT / "tardis_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


# imported only inside the functions that use them: the carsus loader,
# the HDF writers and model readers, the progress bars, the notebook
# log panel, the analysis tables and the plots (matplotlib and plotly)
LAZY = ("h5py", "pandas", "tables", "tqdm", "IPython", "ipywidgets",
        "matplotlib", "plotly")


def _module_level_imports(path: Path):
    """The modules ``path`` imports at module level (not inside a function
    or a class body)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_module_level_h5py_or_pandas(path):
    """h5py, pandas, tqdm, IPython / ipywidgets, matplotlib and plotly are
    imported only where the loader, the writers, the readers, a progress
    bar, the notebook panel, an analysis table or a plot run, so the rest
    of the port (and a card's machine without them) never needs them."""
    bad = [m for m in _module_level_imports(path)
           if m.split(".")[0] in LAZY]
    assert not bad, f"{path.name} imports {bad} at module level"


def test_port_imports_without_h5py_and_pandas():
    """Every module of the port imports in a process where none of LAZY
    (h5py, pandas, PyTables, tqdm, IPython, ipywidgets, matplotlib, plotly)
    can be imported."""
    import subprocess
    import sys

    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "tardis_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in LAZY)
            + "import importlib\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in modules))
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]


def test_default_device_raises_without_a_card(monkeypatch):
    """run_tardis defaults to the card and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_tardis(copy.deepcopy(CONFIG))


def test_formal_integral_solver_defaults_to_the_card(monkeypatch):
    """FormalIntegralSolver has no CPU default: without a device it asks for
    the card and raises where there is none."""
    from tardis_torch.spectrum.formal_integral import FormalIntegralSolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FormalIntegralSolver().solve(None, None, None, None, None)


def test_refused_options_name_themselves():
    cfg = copy.deepcopy(CONFIG)
    cfg["plasma"]["helium_treatment"] = "recomb-nlte"
    cfg["plasma"]["nlte"] = {"species": ["He 1"]}
    with pytest.raises(ValueError, match="helium_treatment"):
        run_tardis(cfg, device="cpu")
    cfg = copy.deepcopy(CONFIG)
    cfg["spectrum"]["virtual"] = {"enable_biasing": True}
    with pytest.raises(NotImplementedError, match="enable_biasing"):
        run_tardis(cfg, device="cpu")
    cfg = copy.deepcopy(CONFIG)
    cfg["spectrum"]["integrated"] = {"compute": "numba"}
    with pytest.raises(ValueError, match="compute"):
        run_tardis(cfg, device="cpu")
    # continuum species are no longer refused: the classic loop runs, with
    # the plasma in host line mode, as in the JAX package
    cfg = copy.deepcopy(CONFIG)
    cfg["plasma"]["continuum_interaction"] = {"species": ["H I"]}
    cfg["montecarlo"].update(iterations=1, no_of_packets=64,
                             last_no_of_packets=64)
    sim = run_tardis(cfg, device="cpu")
    assert not sim._device_line_ok() and sim.spectrum_real.luminosity > 0


def test_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor on a card makes each kernel
    wrapper raise instead of taking its plain version, and the pointer
    checks refuse a wrong dtype."""
    from tardis_torch import cuda
    from tardis_torch.energy_input.gamma_kernel import gamma_step_transport
    from tardis_torch.plasma.line_tables import LineStatic, line_tables
    from tardis_torch.spectrum.formal_integral import integrate_rays
    from tardis_torch.transport.kernel import transport_loop
    from tardis_torch.transport.nonhomologous import (
        NonhomTables,
        nonhom_transport_loop,
    )
    from tardis_torch.transport.source import blackbody_source
    from tardis_torch.transport.tables import TransportTables
    from tardis_torch.transport.vpacket import trace_vpacket_records

    meta = torch.device("meta")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=meta)

    for pool in ("simple", "relativistic", "weighted"):
        with pytest.raises(ValueError, match="unsupported device"):
            blackbody_source((0, 1), 8, 1e4, meta, pool, beta_inner=0.03)
    static = LineStatic(*(empty(4, dtype=d) for d in (
        torch.int32, torch.int32, *[torch.float64] * 5)))
    with pytest.raises(ValueError, match="unsupported device"):
        line_tables(static, empty(3, 2, dtype=torch.float64), [1e4] * 2,
                    [0.5] * 2, 1e6)
    tables = TransportTables(
        r_inner=empty(2), r_outer=empty(2), chi_e=empty(2), line_nu=empty(4),
        prefix=empty(2, 5, dtype=torch.float64),
        line2macro=empty(4, dtype=torch.int32), chain_cdf=empty(1, 1),
        emit_cdf=empty(1, 3), mode=0,
    )
    for full_relativity, albedo in ((False, 0.0), (True, 0.5)):
        tables.full_relativity = full_relativity
        tables.inner_boundary_albedo = albedo
        for kw in ({}, dict(pool_w=empty(8), last_interaction=True,
                            tracker_length=4)):
            with pytest.raises(ValueError, match="unsupported device"):
                transport_loop(tables, empty(8), empty(8), (0, 1), **kw)
        with pytest.raises(ValueError, match="unsupported device"):
            trace_vpacket_records(tables, empty(3, 8), 2, empty(5))
    with pytest.raises(ValueError, match="unsupported device"):
        integrate_rays(empty(3), empty(2), empty(2), empty(2), empty(2),
                       empty(4), *(empty(2, 4) for _ in range(4)), empty(3))
    nh = NonhomTables(
        r_inner=empty(2), r_outer=empty(2), beta_in=empty(2),
        m_grad=empty(2), chi_e=empty(2), line_nu=empty(4),
        prefix=empty(2, 5, dtype=torch.float64),
        rev_prefix=empty(2, 5, dtype=torch.float64), mode=0)
    for albedo in (0.0, 0.5):
        nh.inner_boundary_albedo = albedo
        for kw in ({}, dict(last_interaction=True, tracker_length=4)):
            with pytest.raises(ValueError, match="unsupported device"):
                nonhom_transport_loop(nh, empty(8), empty(8), (0, 1), **kw)
    packets = [empty(8) for _ in range(4)] + [
        empty(8, dtype=torch.int32), empty(8, dtype=torch.int32), empty(8)]
    shells = [empty(2) for _ in range(5)]
    for opts in ({}, dict(grey_opacity=0.1), dict(collect_estimators=True),
                 dict(photoabsorption_type="kasen", pair_creation_type="artis",
                      kasen_z4=empty(2))):
        with pytest.raises(ValueError, match="unsupported device"):
            gamma_step_transport(*packets, (0, 1), *shells, empty(64),
                                 empty(64, 128), empty(11), **opts)
    assert integrate_rays.launches == 0
    assert not line_tables.launches_by_variant
    assert not blackbody_source.launches_by_variant
    assert not transport_loop.launches_by_variant
    assert not trace_vpacket_records.launches_by_variant
    assert not nonhom_transport_loop.launches_by_variant
    assert not gamma_step_transport.launches_by_variant
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="float64"):
        cuda.check_cuda("k", cpu, prefix=(torch.zeros(3), torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        cuda.check_cuda("k", cpu, out=(torch.zeros(3, 2).T, torch.float32))


def test_continuum_modules_are_scanned():
    """The continuum plasma, the Markov macro atom and the workflows are
    among the files the import scan reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("plasma/continuum.py", "opacities/continuum_macro.py",
                 "workflows/simple.py", "workflows/type_iip.py"):
        assert f"tardis_torch/{name}" in scanned, name


def test_nonhomologous_and_gamma_modules_are_scanned():
    """The nonhomologous loop, the gamma-ray step, the decay modules and
    their workflows are among the files the import scan reads, and their
    kernels are registered for the build."""
    from tardis_torch import cuda

    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("model/geometry.py", "model/decay.py",
                 "opacities/macro_atom_solver.py",
                 "transport/nonhomologous.py", "energy_input/decay.py",
                 "energy_input/gamma_kernel.py", "workflows/nonhomologous.py",
                 "workflows/high_energy.py"):
        assert f"tardis_torch/{name}" in scanned, name
    for kernel in ("nonhom_loop", "gamma_step"):
        assert kernel in cuda.KERNELS
        assert (ROOT / "tardis_torch" / "csrc" / f"{kernel}.cu").exists()


def test_parallel_and_probe_modules_are_scanned():
    """The packet-parallel transport and the probe are among the files
    the import scan reads, and the probe's kernels are registered for the
    build."""
    from tardis_torch import cuda

    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("parallel/transport.py", "benchmarks/probe2.py"):
        assert f"tardis_torch/{name}" in scanned, name
    assert "probe2" in cuda.KERNELS
    assert (ROOT / "tardis_torch" / "csrc" / "probe2.cu").exists()


def test_benchmark_harnesses_are_scanned():
    """The three benchmark harnesses and the bounds they share with
    chip_smoke.py are among the files the import scans read."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("transport_bench", "production_run", "scaling_bench",
                 "bounds"):
        assert f"tardis_torch/benchmarks/{name}.py" in scanned, name
    assert "chip_smoke.py" in scanned


def test_device_list_asks_for_the_cards(monkeypatch):
    """A list of CUDA devices is no longer refused: without a card it
    raises as the default device does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_tardis(copy.deepcopy(CONFIG), device=["cuda:0", "cuda:1"])


def test_workflows_default_to_the_card(monkeypatch):
    """The workflows, like run_tardis, ask for the card by default and
    raise where there is none."""
    from tardis_torch.workflows.nonhomologous import (
        NonhomologousTARDISWorkflow,
    )
    from tardis_torch.workflows.simple import SimpleTARDISWorkflow
    from tardis_torch.workflows.type_iip import TypeIIPWorkflow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (SimpleTARDISWorkflow, TypeIIPWorkflow,
                NonhomologousTARDISWorkflow):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(copy.deepcopy(CONFIG))


def test_continuum_wrapper_never_falls_back():
    """K1 with continuum tables on a tensor that is neither on the CPU nor
    on a card raises instead of taking its plain version, and refuses
    spawn records."""
    from tardis_torch.transport.kernel import transport_loop
    from tardis_torch.transport.tables import (
        ContinuumTables,
        TransportTables,
    )

    meta = torch.device("meta")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=meta)

    i32 = torch.int32
    cont = ContinuumTables(
        grid_nu=empty(3), xsect=empty(6), coef_a=empty(4), coef_b=empty(4),
        boltz_coef=empty(2), ff_coef=empty(2), mk_cum_b=empty(18),
        deact_block_start=empty(4, dtype=i32), deact_cum_prob=empty(6),
        deact_kind=empty(3, dtype=torch.int8), deact_id=empty(3, dtype=i32),
        line2state=empty(4, dtype=i32), photo_ion_state=empty(2, dtype=i32),
        fb_cdf=empty(8), fb_nu=empty(4), pion_block_start=empty(3, dtype=i32),
        two_photon_nu=empty(1), k_state=2)
    tables = TransportTables(
        r_inner=empty(2), r_outer=empty(2), chi_e=empty(2), line_nu=empty(4),
        prefix=empty(2, 5, dtype=torch.float64),
        line2macro=empty(4, dtype=i32), chain_cdf=empty(1, 1),
        emit_cdf=empty(1, 3), mode=2, full_relativity=True, continuum=cont,
    )
    with pytest.raises(ValueError, match="unsupported device"):
        transport_loop(tables, empty(8), empty(8), (0, 1), pool_w=empty(8),
                       last_interaction=True)
    # records with continuum select K1's continuum records instantiation;
    # the classic loop has none (it tests the capacity at run time)
    from tardis_torch.transport.kernel import (
        library_defines,
        variant,
        variant_name,
    )
    flags = variant(tables, vpacket_capacity=16)
    assert variant_name(flags).split("+")[-1] == "records"
    assert "TL_RECORDS=1" in library_defines(flags)
    classic = TransportTables(**{**vars(tables), "continuum": None})
    assert "TL_RECORDS=0" in library_defines(variant(
        classic, vpacket_capacity=16))
    assert not transport_loop.launches_by_variant


def test_model_io_and_cli_modules_are_scanned():
    """The model readers, the HDF writers, the logger, the debug packet
    log, the CMFGEN converter and the command line are among the files
    the import scan reads."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("model/state.py", "io/csvy.py", "io/model_readers.py",
                 "io/cmfgen2tardis.py", "io/logger.py", "io/hdf.py",
                 "io/pandas_hdf_writer.py", "io/debug_packets.py", "cli.py"):
        assert f"tardis_torch/{name}" in scanned, name


def test_analysis_grid_utils_and_plots_are_scanned():
    """The analysis, grid, utils and visualization packages and the two
    workflow modules around the run are among the files the import scans
    read, every module of those packages included."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("workflows/util.py", "workflows/v_inner_solver.py",
                 "analysis/last_interaction.py", "analysis/line_info.py",
                 "analysis/shell_info.py", "analysis/opacities.py",
                 "analysis/history.py", "grid/base.py", "utils/base.py",
                 "visualization/convergence.py",
                 "visualization/widgets/shell_info.py",
                 "visualization/widgets/line_info.py"):
        assert f"tardis_torch/{name}" in scanned, name
    for package in ("analysis", "grid", "utils", "visualization"):
        files = sorted((ROOT / "tardis_torch" / package).rglob("*.py"))
        assert files and set(files) <= set(_port_files()), package


def test_every_jax_module_has_a_port():
    """The six plot modules are among the scanned files, and every module
    of the JAX package's visualization package has its counterpart in the
    port's."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("lineid", "custom_abundance", "grotrian", "liv", "rpacket",
                 "sdec"):
        assert f"tardis_torch/visualization/{name}.py" in scanned, name
    ref = ROOT / "tardis_tpu" / "visualization"
    for path in ref.rglob("*.py"):
        port = ROOT / "tardis_torch" / "visualization" / path.relative_to(ref)
        assert port in _port_files(), port


# tardis_tpu modules with no file in the port, each with its reason
NOT_PORTED = {
    **{f"benchmarks/{name}.py": "an XLA:TPU probe of the lockstep step; "
       "the port's are benchmarks/event_loops.py, ray_kernels.py and "
       "chip_smoke.py's lane_efficiency"
       for name in ("occupancy_probe", "probe_loop_ops", "probe_loop_ops2",
                    "probe_scatter", "probe_scatter_gather", "probe_step2",
                    "probe_step3", "profile_step")},
    "native/__init__.py": "optional host C++ for the line tables: K3 builds "
                          "them on the card",
    "utils/twofloat.py": "two-float f32 pairs for a device without f64: the "
                         "port keeps f64 on the card",
    "utils/search.py": "the TPU's packed-row searches: the port searches "
                       "with torch.searchsorted and K1 / K6 / K7's own",
    "plasma/device_line.py": "the line-table program: K3 "
                             "(plasma/line_tables.py) subsumes it",
    "transport/device_state.py": "the packed tau tables: K1's flat f64 "
                                 "prefixes subsume them",
    "transport/tiled_search.py": "the tiled predicate search: K1's search "
                                 "subsumes it",
}

# public names of ported modules with no counterpart of the same name in
# the port's file, each with its reason
NAMES_NOT_PORTED = {
    "benchmarks/probe2.py": {
        "timeit": "the JAX probe's XLA timer; the port times with CUDA "
                  "events"},
    "benchmarks/transport_bench.py": {
        "measure_row_costs": "the TPU's gather and scatter unit costs, "
                             "the budget of six row gathers a lockstep "
                             "step (ROOFLINE_GATHERS); the port's roofline "
                             "is K1's byte and operation bound "
                             "(benchmarks/bounds.py k1_bound)"},
    "parallel/transport.py": {
        "packet_mesh": "a JAX device mesh; the port takes a device list",
        "shard_map": "JAX's shard_map shim; the port launches K1 a shard"},
    "plasma/nlte.py": {
        "interp_yg": "kept once, in plasma/continuum.py, and imported"},
    "transport/kernel.py": {
        name: "the XLA lockstep step and its carry: K1 "
              "(transport_loop) replaces them"
        for name in ("TransportCarry", "init_carry", "make_transport_step",
                     "run_transport")},
    "transport/nonhomologous.py": {
        name: "the XLA nonhomologous step: K7 (nonhom_transport_loop) "
              "replaces it"
        for name in ("make_nonhom_step", "run_nonhom_transport")},
    "transport/source.py": {
        name: "the three pools are modes of K2's blackbody_source"
        for name in ("sample_blackbody_packets",
                     "sample_blackbody_packets_relativistic",
                     "sample_blackbody_packets_weighted")},
}


def _public_names(path: Path):
    """Public top-level functions and classes of ``path`` and the public
    methods of those classes (``Class.method``)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{sub.name}" for sub in node.body
                           if isinstance(sub, (ast.FunctionDef,
                                               ast.AsyncFunctionDef))
                           and not sub.name.startswith("_"))
    return out


def _defined_names(path: Path):
    """Every name ``path`` defines at top level (functions, classes,
    assignments; imports do not count) and every method or class
    attribute of its classes (``Class.name``)."""
    out = set()

    def targets(node):
        for t in (node.targets if isinstance(node, ast.Assign)
                  else [node.target]):
            yield from (n.id for n in ast.walk(t) if isinstance(n, ast.Name))

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.add(f"{node.name}.{sub.name}")
                elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    out.update(f"{node.name}.{n}" for n in targets(sub))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(targets(node))
    return out


def test_every_jax_file_and_name_has_a_port():
    """Every tardis_tpu/**/*.py has a file at the same path in
    tardis_torch/ and every public function, class and method of it a
    counterpart of the same name there, but for NOT_PORTED and
    NAMES_NOT_PORTED, each entry with its reason; neither list names the
    atomic data download or a plot module, and no plot module of the port
    raises NotImplementedError."""
    ref = ROOT / "tardis_tpu"
    missing, names = [], {}
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        port = ROOT / "tardis_torch" / rel
        if not port.exists():
            if rel not in NOT_PORTED:
                missing.append(rel)
            continue
        assert rel not in NOT_PORTED, f"{rel} is ported: drop its exclusion"
        skip = NAMES_NOT_PORTED.get(rel, {})
        lost = sorted(
            n for n in _public_names(path) - _defined_names(port)
            if n.split(".")[0] not in skip)
        if lost:
            names[rel] = lost
        stale = [n for n in skip if n not in _public_names(path)
                 or n in _defined_names(port)]
        assert not stale, f"{rel}: stale exclusions {stale}"
    assert not missing, f"no port of {missing}"
    assert not names, f"no counterpart of {names}"
    assert all(reason for reason in NOT_PORTED.values())
    assert all(reason for d in NAMES_NOT_PORTED.values()
               for reason in d.values())
    assert all((ref / rel).exists() for rel in NOT_PORTED)
    excluded = set(NOT_PORTED) | set(NAMES_NOT_PORTED)
    assert "atomic/download.py" not in excluded
    assert not [rel for rel in excluded
                if rel.startswith("visualization/")]
    for path in sorted((ROOT / "tardis_torch" / "visualization")
                       .rglob("*.py")):
        assert "NotImplementedError" not in path.read_text(), path
