"""Spectral-line identification markers on a spectrum plot.

Counterpart of ``tardis_tpu/visualization/lineid.py`` (the reference's
``lineid_plotter``, tardis/visualization/tools/lineid_plotter.py:10-129,
which wraps the external ``lineid_plot`` package).  The marker layout that
package provides is drawn here with matplotlib: a vertical tick and a
connector per line, the label boxes pushed apart horizontally so that they
never overlap.  Everything here is host-side drawing on the axis it is
given.

API parity: ``lineid_plotter(ax, line_wavelengths, line_labels,
spectrum_wavelengths, spectrum_data, style={'top','inside','along'})``.
"""

from __future__ import annotations

import numpy as np


def _deoverlap(positions, min_sep):
    """Push label x-positions apart so neighbours are >= min_sep apart,
    preserving order and keeping the mean displacement minimal (simple
    forward/backward relaxation sweep — the same service lineid_plot's
    ``get_box_loc`` provides)."""
    pos = np.asarray(positions, np.float64).copy()
    order = np.argsort(pos)
    p = pos[order]
    for _ in range(200):
        moved = False
        for i in range(1, len(p)):
            gap = p[i] - p[i - 1]
            if gap < min_sep:
                shift = 0.5 * (min_sep - gap)
                p[i - 1] -= shift
                p[i] += shift
                moved = True
        if not moved:
            break
    out = np.empty_like(pos)
    out[order] = p
    return out


def lineid_plotter(
    ax,
    line_wavelengths,
    line_labels,
    spectrum_wavelengths,
    spectrum_data,
    style: str = "top",
    plotter_kwargs: dict | None = None,
    lineid_kwargs: dict | None = None,
):
    """Annotate ``ax`` with line identification markers.

    Parameters mirror the reference: ``style`` is 'top' (labels above the
    axes), 'inside' (labels at 90% axes height), or 'along' (labels follow
    the local spectrum level).  ``lineid_kwargs`` accepts ``box_axes_space``
    (label row offset, axes fraction) and ``max_iter`` overrides.
    Returns the axis.
    """
    plotter_kwargs = plotter_kwargs or {}
    lineid_kwargs = lineid_kwargs or {}
    wl = np.asarray(line_wavelengths, np.float64)
    if len(wl) != len(line_labels):
        raise ValueError(
            "line_wavelengths and line_labels must have the same length"
        )
    spec_wl = np.asarray(spectrum_wavelengths, np.float64)
    spec_y = np.asarray(spectrum_data, np.float64)
    order = np.argsort(spec_wl)
    spec_wl, spec_y = spec_wl[order], spec_y[order]

    x0, x1 = ax.get_xlim() if ax.has_data() else (spec_wl[0], spec_wl[-1])
    span = x1 - x0
    # label slots wide enough for typical "Si II" boxes
    min_sep = lineid_kwargs.get("label_sep", 0.04) * span
    box_x = _deoverlap(wl, min_sep)

    def axes_y(frac):
        lo, hi = ax.get_ylim()
        return lo + frac * (hi - lo)

    flux_at = np.interp(wl, spec_wl, spec_y)
    if style == "top":
        arrow_tip = np.full(len(wl), axes_y(1.0))
        box_y = np.full(len(wl), axes_y(1.06))
        clip = False
    elif style == "inside":
        arrow_tip = np.full(len(wl), axes_y(0.8))
        box_y = np.full(len(wl), axes_y(0.9))
        clip = True
    elif style == "along":
        lo, hi = ax.get_ylim()
        arrow_len = 0.1 * (hi - lo)
        arrow_tip = np.minimum(flux_at + 2 * arrow_len, axes_y(0.8))
        box_y = np.minimum(flux_at + 3 * arrow_len, axes_y(0.9))
        clip = True
    else:
        raise ValueError(
            "style must be one of 'top', 'inside', or 'along'"
        )

    for x, bx, tip, by, label in zip(wl, box_x, arrow_tip, box_y,
                                     line_labels):
        ax.annotate(
            label,
            xy=(x, tip),
            xytext=(bx, by),
            rotation=90,
            ha="center",
            va="bottom",
            fontsize=lineid_kwargs.get("fontsize", 8),
            annotation_clip=clip,
            arrowprops=dict(arrowstyle="-", lw=0.7, color="0.3",
                            shrinkA=0.0, shrinkB=0.0),
            **plotter_kwargs,
        )
        ax.plot(
            [x, x], [np.interp(x, spec_wl, spec_y), tip],
            lw=0.4, color="0.6", zorder=1,
        )
    return ax
