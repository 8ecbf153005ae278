"""Spectral element DEComposition (SDEC) plot.

Counterpart of ``tardis_tpu/visualization/sdec.py`` (the reference's
``SDECPlotter``, tardis/visualization/tools/sdec_plot.py:30):

- **emission decomposition**: emergent luminosity split by the species of
  each escaping packet's last line interaction, plus a no-interaction
  (photosphere) and an electron-scattering-only component;
- **absorption decomposition**: the luminosity each species removed from
  the field, binned at the absorbed frequency of escaping packets' last
  line absorptions (plotted downward);
- **packets_mode**: "real" (escaping r-packets and K1's last-interaction
  rows) or "virtual" (the ``virt_packet_*`` arrays of vpacket logging);
- **species filtering / top-N grouping**: ``species_list`` like
  ["Si II", "Ca", "S I-III"] or ``nelements`` keeps the strongest
  contributors and folds the rest into "other";
- **flux mode**: ``distance`` turns luminosity density into observed flux
  (L / 4 pi d^2), ``observed_spectrum=(wl_A, flux)`` overplots data,
  ``show_modeled_spectrum`` toggles the total line and
  ``blackbody_photosphere`` overlays the t_inner blackbody.

The packet arrays and the decomposition are taken in torch on the device
the transport result lives on (``_packet_arrays``, ``_decompose``): K1's
output and last-interaction rows stay there, the virtual packets' arrays
are copied there, every histogram is a ``bincount`` over the bins of
``bucketize`` (``histogram``, the bins of ``np.histogram``), and only the
per-species histograms reach the host.  The plot is drawn on the host
from those host arrays: with matplotlib, imported inside
``generate_plot_mpl``, or with plotly, imported inside
``generate_plot_ply``.
"""

from __future__ import annotations

import numpy as np
import torch

from tardis_torch.atomic.atom_data import ATOMIC_SYMBOLS, SYMBOL_TO_Z
from tardis_torch.constants import C
from tardis_torch.transport.tables import NU_UNIT

ROMAN = {"I": 0, "II": 1, "III": 2, "IV": 3, "V": 4, "VI": 5, "VII": 6,
         "VIII": 7}


def _parse_species_list(species_list):
    """["Si II", "Ca", "S I-III"] -> set of (Z, ion) pairs (ion None: every
    ion of the element)."""
    if species_list is None:
        return None
    out = set()
    for token in species_list:
        parts = token.replace("_", " ").split()
        z = SYMBOL_TO_Z[parts[0].capitalize()]
        if len(parts) == 1:
            out.add((z, None))
        elif "-" in parts[1]:
            a, b = parts[1].split("-")
            for i in range(ROMAN[a], ROMAN[b] + 1):
                out.add((z, i))
        else:
            ion = ROMAN.get(parts[1])
            out.add((z, int(parts[1]) - 1 if ion is None else ion))
    return out


def _roman(ion):
    numerals = ["I", "II", "III", "IV", "V", "VI", "VII", "VIII", "IX", "X"]
    return numerals[ion] if 0 <= ion < len(numerals) else str(ion + 1)


def on_device(a, device, dtype=None):
    """A host array (or list) as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def histogram(x, weights, edges):
    """``np.histogram(x, bins=edges, weights=weights)[0]`` on ``x``'s
    device: bins [e_i, e_i+1), the last one closed, values outside
    dropped; ``weights`` None counts."""
    n = edges.shape[0] - 1
    i = torch.bucketize(x, edges, right=True) - 1
    i = torch.where(x == edges[-1], n - 1, i)
    ok = (i >= 0) & (i < n)
    w = None if weights is None else weights[ok]
    return torch.bincount(i[ok], weights=w, minlength=n)


class SDECPlotter:
    """Decompose a finished simulation's spectrum by interaction species."""

    def __init__(self, sim):
        res = sim.last_transport_result
        if res is None or res._li is None:
            raise ValueError("needs a finished simulation with tracking")
        self.sim = sim
        self.res = res
        self.atom = sim.atom_data
        self.device = res._out.device

    @classmethod
    def from_simulation(cls, sim):
        return cls(sim)

    # ------------------------------------------------------------------
    def _packet_arrays(self, packets_mode):
        """(nu_out, e_out, nu_in, li_type, in_line, out_line) of the chosen
        packet population, tensors on the result's device (frequencies in
        Hz, luminosities in erg / s, f64)."""
        res = self.res
        if packets_mode == "real":
            out, li = res._out, res._li
            m = out[:, 0] > 0
            return (
                out[m, 0].double() * NU_UNIT,
                out[m, 1].double() * (1.0 / res.n_packets)
                / res.time_of_simulation,
                li[m, 4].double() * NU_UNIT,
                li[m, 0].long(),
                li[m, 1].long(),
                li[m, 2].long(),
            )
        if packets_mode == "virtual":
            vp = res.vpackets
            if vp is None:
                raise ValueError(
                    "virtual packets_mode needs vpacket_tracking "
                    "(spectrum.virtual.virtual_packet_logging) enabled"
                )
            dev, f64 = self.device, torch.float64
            out_line = on_device(
                vp["virt_packet_last_line_interaction_out_id"], dev,
                torch.long)
            return (
                on_device(vp["virt_packet_nus"], dev, f64),
                on_device(vp["virt_packet_energies"], dev, f64)
                / res.time_of_simulation,
                on_device(vp["virt_packet_last_interaction_in_nu"], dev, f64),
                on_device(vp["virt_packet_last_interaction_type"], dev,
                          torch.long),
                out_line,  # spawn records do not keep the absorbed line
                out_line,
            )
        raise ValueError(f"unknown packets_mode {packets_mode!r}")

    # ------------------------------------------------------------------
    def _decompose(self, nu_edges, packets_mode="real", species_filter=None,
                   nelements=None):
        """The emission and absorption components, {label: L_nu per bin}
        (host f64 arrays), each histogram taken on the result's device."""
        nu_out, e_out, nu_in, li_type, in_line, out_line = (
            self._packet_arrays(packets_mode)
        )
        edges = on_device(nu_edges, self.device, torch.float64)
        d_nu = torch.diff(edges).abs()
        line_z = on_device(self.atom.line_z, self.device, torch.long)
        line_ion = on_device(self.atom.line_ion, self.device, torch.long)
        last = self.atom.n_lines - 1

        def hist(nu, w, mask):
            return histogram(nu[mask], w[mask], edges) / d_nu

        def species(line):
            valid = line >= 0
            lid = line.clamp(0, last)
            return (torch.where(valid, line_z[lid], -1),
                    torch.where(valid, line_ion[lid], -1))

        emission = {
            "photosphere": hist(nu_out, e_out, li_type <= 0),
            "e-scattering": hist(nu_out, e_out, li_type == 1),
        }
        absorption = {}
        if species_filter is not None:
            keys = set(species_filter)

            def allowed(z, ion):
                return (z, None) in keys or (z, ion) in keys
        else:
            def allowed(z, ion):
                return True

        for comp, nu, line in ((emission, nu_out, out_line),
                               (absorption, nu_in, in_line)):
            is_line = (li_type == 2) & (line >= 0)
            z_of, ion_of = species(line)
            pairs = torch.unique(torch.stack(
                [z_of[is_line], ion_of[is_line]], dim=1), dim=0)
            for z, ion in pairs.tolist():
                if z <= 0 or not allowed(z, ion):
                    continue
                label = _species_label(z, ion, species_filter)
                h = hist(nu, e_out, is_line & (z_of == z) & (ion_of == ion))
                comp[label] = comp[label] + h if label in comp else h

        emission = {k: v.cpu().numpy() for k, v in emission.items()}
        absorption = {k: v.cpu().numpy() for k, v in absorption.items()}
        if nelements is not None:
            totals = {k: np.sum(v) for k, v in emission.items()
                      if k not in ("photosphere", "e-scattering")}
            top = set(sorted(totals, key=totals.get,
                             reverse=True)[:nelements])
            emission = _fold_other(emission, top,
                                   keep=("photosphere", "e-scattering"))
            absorption = _fold_other(absorption, top, keep=())
        return emission, absorption

    # ------------------------------------------------------------------
    def _photosphere_luminosity_lambda(self, wl_angstrom):
        """Blackbody L_lambda of the photosphere [erg / s / Angstrom]:
        pi B_lambda(t_inner) 4 pi r_inner^2."""
        from tardis_torch.constants import H, K_B

        t = self.sim.state.t_inner
        r = self.sim.state.geometry.r_inner[0]
        lam_cm = np.asarray(wl_angstrom) * 1e-8
        x = H * C / (lam_cm * K_B * t)
        b_lam = 2.0 * H * C**2 / lam_cm**5 / np.expm1(np.clip(x, 1e-10,
                                                              500.0))
        return np.pi * b_lam * 4.0 * np.pi * r**2 * 1e-8

    def _prep(self, packets_mode, species_list, nelements, wl_range):
        nu_edges = self.sim.spectrum_nu_edges
        emission, absorption = self._decompose(
            nu_edges, packets_mode, _parse_species_list(species_list),
            nelements)
        centers = 0.5 * (nu_edges[:-1] + nu_edges[1:])
        wl = C / centers * 1e8
        order = np.argsort(wl)
        to_lam = centers**2 / C / 1e8  # L_nu -> L_lambda per Angstrom

        def conv(h):
            return (h * to_lam)[order]

        labels_e = list(emission)
        em_stack = [conv(emission[k]) for k in labels_e]
        labels_a = list(absorption)
        ab_stack = [conv(absorption[k]) for k in labels_a]
        total = np.sum(em_stack, axis=0) if em_stack else np.zeros_like(wl)
        return wl[order], em_stack, ab_stack, labels_e, labels_a, total

    def generate_plot_mpl(
        self,
        packets_mode: str = "real",
        ax=None,
        species_list=None,
        nelements=None,
        wavelength_range_angstrom=None,
        save_path: str | None = None,
        distance=None,
        observed_spectrum=None,
        show_modeled_spectrum: bool = True,
        blackbody_photosphere: bool = True,
    ):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        # flux mode: L / (4 pi d^2), d in cm; checked before any data prep
        lum_to_flux = 1.0
        if distance is not None:
            if distance <= 0:
                raise ValueError("distance must be positive")
            lum_to_flux = 4.0 * np.pi * float(distance) ** 2
        elif observed_spectrum is not None:
            raise ValueError(
                "plotting an observed spectrum requires distance"
            )
        wl, em_stack, ab_stack, labels_e, labels_a, total = self._prep(
            packets_mode, species_list, nelements, wavelength_range_angstrom
        )

        def fl(y):
            return y / lum_to_flux

        if ax is None:
            fig, ax = plt.subplots(figsize=(11, 6))
        else:
            fig = ax.figure
        ax.stackplot(wl, [fl(e) for e in em_stack], labels=labels_e,
                     alpha=0.8)
        if len(ab_stack):
            ax.stackplot(wl, [-fl(a) for a in ab_stack],
                         labels=[f"{n} (abs)" for n in labels_a], alpha=0.5)
        if show_modeled_spectrum:
            ax.plot(wl, fl(total), color="k", lw=0.8, label="total")
        if blackbody_photosphere:
            ax.plot(wl, fl(self._photosphere_luminosity_lambda(wl)), "--",
                    color="0.3", lw=0.9, label="blackbody photosphere")
        if observed_spectrum is not None:
            obs_wl, obs_flux = observed_spectrum
            ax.plot(obs_wl, obs_flux, color="tab:red", lw=0.8,
                    label="observed")
        ax.axhline(0.0, color="k", lw=0.5)
        ax.set_xlabel("wavelength [$\\AA$]")
        ax.set_ylabel(
            "$F_\\lambda$ [erg/s/cm$^2$/$\\AA$]" if distance is not None
            else "$L_\\lambda$ [erg/s/$\\AA$]"
        )
        ax.set_title(f"SDEC ({packets_mode} packets)")
        ax.legend(fontsize=8, ncol=3)
        if wavelength_range_angstrom is not None:
            ax.set_xlim(*wavelength_range_angstrom)
        if save_path:
            fig.savefig(save_path, dpi=120)
        return fig

    def generate_plot_ply(
        self,
        packets_mode: str = "real",
        species_list=None,
        nelements=None,
        wavelength_range_angstrom=None,
        distance=None,
        observed_spectrum=None,
        show_modeled_spectrum: bool = True,
        blackbody_photosphere: bool = True,
    ):
        """Interactive plotly figure: the emission and absorption stacks,
        the total, the photosphere's blackbody and an observed spectrum,
        from the host arrays of ``_prep``.  Requires plotly; raises
        ImportError otherwise."""
        import plotly.graph_objects as go

        lum_to_flux = 1.0
        if distance is not None:
            if distance <= 0:
                raise ValueError("distance must be positive")
            lum_to_flux = 4.0 * np.pi * float(distance) ** 2
        elif observed_spectrum is not None:
            raise ValueError(
                "plotting an observed spectrum requires distance"
            )
        wl, em_stack, ab_stack, labels_e, labels_a, total = self._prep(
            packets_mode, species_list, nelements, wavelength_range_angstrom
        )
        fig = go.Figure()
        for name, y in zip(labels_e, em_stack):
            fig.add_trace(go.Scatter(x=wl, y=y / lum_to_flux,
                                     stackgroup="emission", name=name))
        for name, y in zip(labels_a, ab_stack):
            fig.add_trace(go.Scatter(x=wl, y=-y / lum_to_flux,
                                     stackgroup="absorption",
                                     name=f"{name} (abs)"))
        if show_modeled_spectrum:
            fig.add_trace(go.Scatter(x=wl, y=total / lum_to_flux,
                                     name="total",
                                     line=dict(color="black", width=1)))
        if blackbody_photosphere:
            fig.add_trace(go.Scatter(
                x=wl, y=self._photosphere_luminosity_lambda(wl) / lum_to_flux,
                name="blackbody photosphere",
                line=dict(color="gray", width=1, dash="dash")))
        if observed_spectrum is not None:
            obs_wl, obs_flux = observed_spectrum
            fig.add_trace(go.Scatter(x=np.asarray(obs_wl),
                                     y=np.asarray(obs_flux), name="observed",
                                     line=dict(color="red", width=1)))
        fig.update_layout(
            xaxis_title="wavelength [Å]",
            yaxis_title="L_lambda [erg/s/Å]",
            title=f"SDEC ({packets_mode} packets)",
        )
        return fig


def _species_label(z, ion, species_filter):
    sym = ATOMIC_SYMBOLS[z - 1]
    if species_filter is not None and (z, ion) in species_filter:
        return f"{sym} {_roman(ion)}"
    return sym


def _fold_other(components, top, keep):
    out = {}
    other = None
    for k, v in components.items():
        if k in keep or k in top:
            out[k] = v
        else:
            other = v if other is None else other + v
    if other is not None:
        out["other"] = other
    return out
