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
    cfg["montecarlo"]["enable_full_relativity"] = True
    with pytest.raises(NotImplementedError, match="enable_full_relativity"):
        run_tardis(cfg, device="cpu")
    cfg = copy.deepcopy(CONFIG)
    cfg["spectrum"]["virtual"] = {"enable_biasing": True}
    with pytest.raises(NotImplementedError, match="enable_biasing"):
        run_tardis(cfg, device="cpu")
    cfg = copy.deepcopy(CONFIG)
    cfg["spectrum"]["integrated"] = {"compute": "numba"}
    with pytest.raises(ValueError, match="compute"):
        run_tardis(cfg, device="cpu")
    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"]["tracking"]["track_last_interaction"] = True
    with pytest.raises(NotImplementedError, match="track_last_interaction"):
        run_tardis(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="more than one device"):
        run_tardis(copy.deepcopy(CONFIG), device=["cuda:0", "cuda:1"])


def test_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor on a card makes each kernel
    wrapper raise instead of taking its plain version, and the pointer
    checks refuse a wrong dtype."""
    from tardis_torch import cuda
    from tardis_torch.plasma.line_tables import LineStatic, line_tables
    from tardis_torch.spectrum.formal_integral import integrate_rays
    from tardis_torch.transport.kernel import transport_loop
    from tardis_torch.transport.source import blackbody_source
    from tardis_torch.transport.tables import TransportTables
    from tardis_torch.transport.vpacket import trace_vpacket_records

    meta = torch.device("meta")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=meta)

    with pytest.raises(ValueError, match="unsupported device"):
        blackbody_source((0, 1), 8, 1e4, meta)
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
    with pytest.raises(ValueError, match="unsupported device"):
        transport_loop(tables, empty(8), empty(8), (0, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        trace_vpacket_records(tables, empty(3, 8), 2, empty(5))
    with pytest.raises(ValueError, match="unsupported device"):
        integrate_rays(empty(3), empty(2), empty(2), empty(2), empty(2),
                       empty(4), *(empty(2, 4) for _ in range(4)), empty(3))
    assert (blackbody_source.launches, line_tables.launches,
            transport_loop.launches, trace_vpacket_records.launches,
            integrate_rays.launches) == (0, 0, 0, 0, 0)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="float64"):
        cuda.check_cuda("k", cpu, prefix=(torch.zeros(3), torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        cuda.check_cuda("k", cpu, out=(torch.zeros(3, 2).T, torch.float32))
