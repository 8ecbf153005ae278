"""Per-packet debug tracing.

Counterpart of the reference's debug packet logging
(tardis/io/logger/montecarlo_tracking.py:24
``log_decorator`` + the ``debug/log_decorated_functions`` config,
wired at modes/classic/solver.py:99-100); the port's copy of
``tardis_tpu/io/debug_packets.py``.  K1 prints nothing: it keeps the
first K events of each packet (the r-packet tracker,
``montecarlo.tracking.track_rpacket``, read from the device once by
``TransportResult.rpacket_tracker``) and the logs are rendered on the
host afterwards.

Usage::

    from tardis_torch.io.debug_packets import debug_packet_log
    text = debug_packet_log(result, packet_ids=[0, 7])
"""

from __future__ import annotations

import numpy as np

# event/interaction type codes recorded by the kernel tracker
# (matches InteractionType semantics of the reference,
#  transport/montecarlo/packets/radiative_packet.py:12)
EVENT_NAMES = {
    0: "NO_INTERACTION",
    1: "ESCATTERING",
    2: "LINE",
    3: "BOUNDARY",
    4: "CONTINUUM_PROCESS",
    -1: "BIRTH",
}


def packet_events_dataframe(result, packet_id: int):
    """One packet's recorded events as a DataFrame (r [cm], nu [Hz],
    energy, shell, event type)."""
    import pandas as pd

    tracker = result.rpacket_tracker
    if tracker is None:
        raise ValueError(
            "run transport with montecarlo.tracking.track_rpacket enabled "
            "(track_rpacket_length > 0) to record per-packet events"
        )
    nu = tracker["nu"][packet_id]
    valid = nu > 0
    df = pd.DataFrame(
        {
            "r": tracker["r"][packet_id][valid],
            "nu": nu[valid],
            "energy": tracker["energy"][packet_id][valid],
            "shell": tracker["shell"][packet_id][valid],
            "type": tracker["type"][packet_id][valid],
        }
    )
    df["event"] = [EVENT_NAMES.get(int(t), str(int(t))) for t in df["type"]]
    return df


def debug_packet_log(result, packet_ids, logger=None) -> str:
    """Render (and optionally log) the event history of selected packets —
    the information the reference's log_decorator printed per njit call."""
    lines = []
    for pid in np.atleast_1d(packet_ids):
        df = packet_events_dataframe(result, int(pid))
        lines.append(f"packet {int(pid)}: {len(df)} recorded events")
        for step, row in df.iterrows():
            lines.append(
                f"  [{step:3d}] {row['event']:<17} shell={int(row['shell']):3d} "
                f"r={row['r']:.6e} nu={row['nu']:.6e} e={row['energy']:.6e}"
            )
    text = "\n".join(lines)
    if logger is not None:
        logger.debug("%s", text)
    return text
