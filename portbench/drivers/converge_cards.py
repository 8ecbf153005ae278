"""Entry kind ``converge_cards``: the ``converge`` entry kind on the cell's
cards.  Each model is ``Simulation.from_config(..., device=[cuda:0, ...,
cuda:<chips - 1>])``, so the port shards every iteration's packets over
exactly those cards (``parallel/transport.py``: contiguous slices with
``pid_offset``, the sums added on card 0), whatever else the host shows;
on the CPU (the tests' rehearsal) the list is the CPU ``chips`` times.

The loop, the window, the sample and the comparison are ``converge``'s:
sharding changes no semantics, so the plain single-device reference
(``portbench/reference/``, on card 0, its lanes refilled from the pool in
packet order) works out every packet of the sampled iteration again.
"""

import copy

import torch

from portbench.drivers.converge import NAMES as NAMES, Converge
from portbench.drivers.converge import bound_inputs as converge_inputs


class ConvergeCards(Converge):
    def __init__(self, cell: dict, config: dict, device, probe):
        super().__init__(cell, config, device, probe)
        chips = int(cell["chips"])
        self.devices = ([torch.device("cuda", i) for i in range(chips)]
                        if device.type == "cuda" else [device] * chips)
        if self.devices[0] != device:
            raise ValueError(f"the cell's first card is {self.devices[0]}, "
                             f"the run's {device}")

    def _simulation(self, seed: int):
        from tardis_torch.config.reader import config_from_dict
        from tardis_torch.simulation.base import Simulation

        cfg = copy.deepcopy(self.tardis)
        cfg["montecarlo"]["seed"] = seed
        return Simulation.from_config(config_from_dict(cfg),
                                      atom_data=self.atom,
                                      device=list(self.devices))


def make(cell, config, device, probe):
    return ConvergeCards(cell, config, device, probe)


def bound_inputs(driver: ConvergeCards, stats: dict) -> dict:
    """``converge``'s, and the number of cards an iteration runs on."""
    return dict(converge_inputs(driver, stats), k1_cards=len(driver.devices))
