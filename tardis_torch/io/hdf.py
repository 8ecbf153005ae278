"""HDF5 persistence of simulation results.

Counterpart of the reference's ``HDFWriterMixin``
(tardis/io/hdf_writer_mixin.py:14-330): a recursive dump of
the simulation tree (model state, plasma state, transport estimators,
spectra, per-iteration history) into an HDF5 file, with the reference's
group layout (`/simulation/simulation_state/...`).  This is also the
checkpoint format: `load_simulation_state` restores the mutable
radiation-field state {t_rad, W, t_inner, iteration} for resume.

Backend: ``h5py`` (pandas' HDFStore needs PyTables, which is not
needed here), imported inside each function, so the rest of the port
never needs it.  Arrays are plain datasets; scalar groups are stored as
attributes on a ``scalars`` group, so files remain readable with any HDF5
tool.  The port's copy of ``tardis_tpu/io/hdf.py``: the same groups and
keys, so a file either package writes has the other's layout; the
plasma's line tables are torch tensors on the simulation's device and
come to the host here, at the writer.
"""

from __future__ import annotations

import numpy as np

from tardis_torch.io.pandas_hdf_writer import host_array


def _store_array(f, path: str, arr):
    arr = host_array(arr)
    if path in f:
        del f[path]
    f.create_dataset(path, data=arr)


def _store_scalars(f, path: str, scalars: dict):
    grp = f.require_group(path)
    for key, value in scalars.items():
        grp.attrs[key] = value


def read_scalars(path: str, group: str) -> dict:
    """Read back a scalars group written by :func:`_store_scalars`."""
    import h5py

    with h5py.File(path, "r") as f:
        return dict(f[group].attrs)


def simulation_to_hdf(sim, path: str, name: str = "simulation"):
    """Write a Simulation to an HDF file."""
    import h5py

    with h5py.File(path, "w") as store:
        st = sim.state
        prefix = f"/{name}"
        _store_scalars(
            store,
            f"{prefix}/simulation_state/scalars",
            {
                "time_explosion": st.time_explosion,
                "t_inner": st.t_inner,
                "luminosity_requested": st.luminosity_requested,
                "no_of_shells": st.no_of_shells,
                "iterations_executed": sim.iterations_executed,
                "seed": sim.seed,
            },
        )
        _store_array(store, f"{prefix}/simulation_state/v_inner",
                     st.geometry.v_inner)
        _store_array(store, f"{prefix}/simulation_state/v_outer",
                     st.geometry.v_outer)
        _store_array(store, f"{prefix}/simulation_state/t_radiative",
                     st.t_radiative)
        _store_array(store, f"{prefix}/simulation_state/dilution_factor",
                     st.dilution_factor)
        _store_array(store, f"{prefix}/simulation_state/density",
                     st.composition.density)
        _store_array(
            store,
            f"{prefix}/simulation_state/abundance",
            st.composition.mass_fractions,
        )
        _store_array(
            store,
            f"{prefix}/simulation_state/atomic_numbers",
            st.composition.atomic_numbers,
        )

        if sim.plasma_state is not None:
            ps = sim.plasma_state
            _store_array(store, f"{prefix}/plasma/electron_densities",
                         ps.electron_densities)
            _store_array(store, f"{prefix}/plasma/t_electrons",
                         ps.t_electrons)
            _store_array(store, f"{prefix}/plasma/tau_sobolev",
                         ps.tau_sobolev)
            _store_array(store, f"{prefix}/plasma/level_number_density",
                         ps.level_number_density)
            _store_array(store, f"{prefix}/plasma/ion_number_density",
                         ps.ion_number_density)
            # row-index arrays so HDF consumers (shell-info widget) can
            # address the flat ion/level density blocks without the solver
            solver = getattr(sim, "plasma_solver", None)
            atom = getattr(sim, "atom_data", None)
            if solver is not None:
                ion_z, ion_stage = [], []
                for e, z in enumerate(solver.element_z):
                    n_rows = (
                        solver.element_block_start[e + 1]
                        - solver.element_block_start[e]
                        + 1
                    )
                    ion_z.extend([int(z)] * n_rows)
                    ion_stage.extend(range(n_rows))
                _store_array(store, f"{prefix}/plasma/ion_z",
                             np.asarray(ion_z))
                _store_array(store, f"{prefix}/plasma/ion_stage",
                             np.asarray(ion_stage))
            if atom is not None:
                _store_array(store, f"{prefix}/plasma/level_z",
                             atom.level_z)
                _store_array(store, f"{prefix}/plasma/level_ion",
                             atom.level_ion)
                _store_array(store, f"{prefix}/plasma/level_number",
                             atom.level_number)

        res = sim.last_transport_result
        if res is not None:
            t = f"{prefix}/transport_state"
            _store_array(store, f"{t}/output_nu", res.output_nu)
            _store_array(store, f"{t}/output_energy", res.output_energy)
            _store_array(store, f"{t}/output_status", res.output_status)
            _store_array(store, f"{t}/j_estimator", res.j_estimator)
            _store_array(store, f"{t}/nu_bar_estimator", res.nu_bar_estimator)
            _store_scalars(
                store,
                f"{t}/scalars",
                {
                    "time_of_simulation": res.time_of_simulation,
                    "n_packets": res.n_packets,
                },
            )

        for label, spec in (
            ("spectrum", sim.spectrum_real),
            ("spectrum_virtual", sim.spectrum_virtual),
            ("spectrum_integrated", sim.spectrum_integrated),
        ):
            if spec is not None:
                _store_array(store, f"{prefix}/{label}/nu_edges",
                             spec.nu_edges)
                _store_array(store, f"{prefix}/{label}/luminosity_nu",
                             spec.luminosity_nu)

        # per-iteration history (analogue of iterations_* in the reference)
        if sim.history:
            hist = sim.history
            _store_array(
                store,
                f"{prefix}/iterations/t_radiative",
                np.stack([h.t_radiative for h in hist]),
            )
            _store_array(
                store,
                f"{prefix}/iterations/dilution_factor",
                np.stack([h.dilution_factor for h in hist]),
            )
            _store_array(
                store,
                f"{prefix}/iterations/t_inner",
                np.array([h.t_inner for h in hist]),
            )
            _store_array(
                store,
                f"{prefix}/iterations/emitted_luminosity",
                np.array([h.emitted_luminosity for h in hist]),
            )
            _store_array(
                store,
                f"{prefix}/iterations/reabsorbed_luminosity",
                np.array([h.reabsorbed_luminosity for h in hist]),
            )
            _store_array(
                store,
                f"{prefix}/iterations/electron_densities",
                np.stack([h.electron_densities for h in hist]),
            )


def load_simulation_state(path: str, name: str = "simulation") -> dict:
    """Load the checkpointed radiation-field state for resume."""
    import h5py

    with h5py.File(path, "r") as store:
        scalars = store[f"/{name}/simulation_state/scalars"].attrs
        return {
            "t_inner": float(scalars["t_inner"]),
            "t_radiative": store[
                f"/{name}/simulation_state/t_radiative"
            ][()],
            "electron_densities": (
                store[f"/{name}/simulation_state/electron_densities"][()]
                if f"/{name}/simulation_state/electron_densities" in store
                else None
            ),
            "dilution_factor": store[
                f"/{name}/simulation_state/dilution_factor"
            ][()],
            "iterations_executed": int(scalars["iterations_executed"]),
            "seed": int(scalars["seed"]),
            "damping": {
                k[len("damping_"):]: float(scalars[k])
                for k in scalars
                if k.startswith("damping_")
            },
        }


def resume_simulation(sim, path: str, name: str = "simulation"):
    """Restore {t_rad, W, t_inner, iteration} into a fresh Simulation
    (a mid-run resume, which the reference lacks)."""
    ckpt = load_simulation_state(path, name)
    sim.state.t_inner = ckpt["t_inner"]
    sim.state.t_radiative = ckpt["t_radiative"]
    sim.state.dilution_factor = ckpt["dilution_factor"]
    sim.iterations_executed = ckpt["iterations_executed"]
    for key, d in ckpt.get("damping", {}).items():
        if key in sim.convergence_solvers:
            sim.convergence_solvers[key].damping_constant = d
    if ckpt.get("electron_densities") is not None:
        sim.plasma_solver._last_n_e = ckpt["electron_densities"]
    sim.plasma_state = None
    return sim


def save_checkpoint(sim, path: str, name: str = "simulation"):
    """Write the MINIMAL resume state ({t_rad, W, t_inner, iteration,
    seed}) — milliseconds per call, safe to run every iteration.

    Layout-compatible with :func:`load_simulation_state` /
    :func:`resume_simulation`; written atomically (tmp file + rename) so
    a crash mid-write cannot corrupt the previous checkpoint.
    """
    import os

    import h5py

    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as store:
        g = store.create_group(f"/{name}/simulation_state")
        sc = g.create_group("scalars")
        sc.attrs["t_inner"] = float(sim.state.t_inner)
        sc.attrs["iterations_executed"] = int(sim.iterations_executed)
        sc.attrs["seed"] = int(sim.seed)
        # mutable convergence-solver state: the adaptive_damped strategy
        # locally searches and UPDATES its damping constant each
        # iteration, so a bit-faithful resume must restore it
        for key, solver in sim.convergence_solvers.items():
            sc.attrs[f"damping_{key}"] = float(solver.damping_constant)
        g.create_dataset(
            "t_radiative", data=np.asarray(sim.state.t_radiative)
        )
        g.create_dataset(
            "dilution_factor",
            data=np.asarray(sim.state.dilution_factor),
        )
        # the plasma solver warm-starts its n_e fixpoint; a BIT-faithful
        # resume must re-run the most recent solve with the exact seed it
        # consumed (seeding with the converged value would re-converge to
        # a last-ulp-different fixpoint and fork the trajectory)
        seed = getattr(sim.plasma_solver, "_n_e_seed_used", None)
        if seed is not None:
            g.create_dataset(
                "electron_densities", data=np.asarray(seed)
            )
    os.replace(tmp, path)
    return path
