"""integrated / real on the model-file path's csvy and on the main path's
configuration, in both packages.

``chip_smoke.py`` reads integrated / real at ~1.0 on its model-file path
(a csvy with Ni56 / Co56, stratified O-Ca) and at ~1.27 on its main path
(uniform composition).  Both packages run both configurations here at a
small size (synthetic data with Fe / Co / Ni where the csvy needs them, 3
iterations, no virtual packets, the formal integral at 500 frequencies)
and must give the same ratio, so the difference between the paths is the
configurations', not the port's.  Run as a script to print the readings
at another size:

    JAX_PLATFORMS=cpu python -m tests.test_torch_spectrum_ratio \
        [levels] [max level jump] [packets]
"""

import copy
import json
import sys
import tempfile

import pytest
import torch

import chip_smoke as cs
from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.simulation.base import run_tardis as torch_run_tardis
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.simulation.base import run_tardis

torch.set_num_threads(2)

ELEMENTS = {"main": (8, 12, 14, 16, 18, 20),
            "model_file": cs.MODEL_FILE_ELEMENTS}


def case_config(case, packets, tmp):
    cfg = copy.deepcopy(cs.BENCH_CONFIG if case == "main"
                        else cs.MODEL_FILE_CONFIG)
    if case == "model_file":
        cfg["csvy_model"] = f"{tmp}/model.csvy"
        cs.write_model_csvy(cfg["csvy_model"], cs.MODEL_FILE_SHELLS)
    cfg["montecarlo"].update(no_of_packets=packets,
                             last_no_of_packets=2 * packets, iterations=3,
                             no_of_virtual_packets=0)
    cfg["spectrum"].update(num=2000)
    cfg["spectrum"]["integrated"]["points"] = 500
    return cfg


def ratios(case, n_levels, jump, packets, tmp):
    """Each package's integrated and real luminosities and their ratio."""
    zs = ELEMENTS[case]
    atom = make_synthetic_atom_data(
        atomic_numbers=zs, n_levels=n_levels, max_level_jump=jump).prepare(
        selected_atoms=list(zs), line_interaction_type="macroatom")
    cfg = case_config(case, packets, tmp)
    sims = {"jax": run_tardis(copy.deepcopy(cfg), atom_data=atom),
            "port": torch_run_tardis(
                copy.deepcopy(cfg), device="cpu",
                atom_data=atom_data_from_arrays(atom_data_to_arrays(atom)))}
    out = {"lines": atom.n_lines}
    for who, sim in sims.items():
        real = float(sim.spectrum_real.luminosity)
        integrated = float(sim.spectrum_integrated.luminosity)
        out[who] = dict(real=real, integrated=integrated,
                        ratio=integrated / real,
                        requested=float(sim.state.luminosity_requested))
    return out


@pytest.mark.parametrize("case", sorted(ELEMENTS))
def test_integrated_over_real_matches_jax(case, tmp_path):
    """The ratio within 1e-3 of the JAX package's: a few trajectories part
    in the last bits, as in ``test_torch_slice.py`` (1.1e-4 at 100 levels
    and 16,384 packets)."""
    r = ratios(case, 20, 10, 2048, tmp_path)
    assert r["port"]["ratio"] == pytest.approx(r["jax"]["ratio"], rel=1e-3)


if __name__ == "__main__":
    levels, jump, packets = (int(a) for a in (sys.argv[1:] or (40, 20,
                                                                16384)))
    with tempfile.TemporaryDirectory() as tmp:
        for case in sorted(ELEMENTS):
            print(json.dumps(dict(case=case, levels=levels, jump=jump,
                                  packets=packets,
                                  **ratios(case, levels, jump, packets,
                                           tmp))), flush=True)
