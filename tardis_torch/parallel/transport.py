"""Packet-parallel transport over several devices in one process.

Counterpart of ``tardis_tpu/parallel/transport.py``, the JAX package's
production multi-device path: there the packet pool is sharded over a
one-process device mesh, every device runs the event loop on its shard
with global packet ids, and the estimator partials are summed with a
``psum``.  Here the mesh is a list of devices (``packet_devices``; a
device may repeat) and:

- ``_sharded_chunk`` (``:152``) is one K1 launch per shard: shard d takes
  the contiguous slice [d N/D, (d+1) N/D) of the pool, the device-major
  order of ``_chunk_slice`` (``:361-368``), with ``pid_offset`` d N/D, so
  every packet draws the bits of its global id and each packet's outputs
  are bitwise those of a one-device run.  Every shard is launched, on its
  device's current stream, before any is read.  The transport tables are
  sent to each other card inside every iteration (``tables.to(device)``),
  beside its slice of the pool: on the tardis_example W7 problem (20
  shells, 183,060 lines, 3,606 macro-atom levels) the tables are 140.5
  MB a card (the tau prefix 29.3 MB of it, the chain CDFs most of the
  rest), and the slices 8 B a packet.  PyTorch runs a copy between two
  cards on the source card's current stream, so these sends queue on the
  first card's stream behind its own shard's launch;
- ``_final_reduce`` (``:241``) is ``_final_reduce`` below: the per-shard
  estimator partials are copied to the first device and summed there in
  f64 in shard order (the adds are queued on the first device's stream in
  that order, so the sum does not depend on which shard finishes first),
  and the per-packet outputs are concatenated in shard order.  A copy
  between two cards is ordered after the producing stream and before the
  consuming one by PyTorch's copy itself, which records an event on the
  source's current stream and makes the destination's current stream
  wait on it;
- ``_device_repack`` (``:123``), the compaction of a lane pool's survivors
  for the drain tail, is subsumed: each K1 launch is a persistent grid
  whose lanes refill from a packet queue until it is spent, as
  ``_repack_jit`` (``kernel.py:1360``) is subsumed;
- the watchdog chunking (``:306-345``) is a TPU workaround and is not
  carried over: every shard is one launch.

The collective stays outside the kernel, as peer copies and torch adds.
The JAX path is one process, and users call ``run_tardis`` once, so no
``torch.distributed`` process group is involved.  Only the classic
``TransportSolver.run_iteration`` shards, as in the JAX package.

The trace recorder (``tardis_torch/tracing.py``) sees each shard's sends
in a ``tardis.shard_tables`` span, the reduce in a ``tardis.shard_reduce``
span and, on the card, as a launch interval of its own on the first
device (``_final_reduce``, variant ``shard_reduce``: from the reduce's
enqueue to its last add, so its end marks the gathered outputs), and
counts ``shard.shards`` and ``shard.peer_bytes``: the bytes of the tables,
pool slices and shard outputs that the iteration queued between two
devices of the list (a device that repeats moves nothing).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from tardis_torch import tracing
from tardis_torch.transport.kernel import (
    MAX_EVENTS,
    TransportOutput,
    transport_loop,
)
from tardis_torch.transport.tables import TransportTables

# fields summed over the shards (f64, or i64 for vp_count and
# search_fallbacks), and fields concatenated in shard order (per packet)
SUM_FIELDS = ("est_j", "est_nubar", "line_diff", "summary", "vp_count",
              "cont_moments", "est_ff_heat", "search_fallbacks", "tail")
CAT_FIELDS = ("out", "last_interaction", "tracker", "events")


def packet_devices(devices=None) -> list[torch.device]:
    """The devices a pool is sharded over: every visible CUDA device by
    default, or ``devices`` as given (a device may repeat), each a
    ``torch.device`` with its index resolved."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("no device to run transport on")
    return out


def _on(device: torch.device):
    """The context that makes ``device`` current (a no-op off the card)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def run_transport_sharded(tables: TransportTables, pool_mu, pool_nu, key,
                          devices, *, nu_window=(0.0, np.inf),
                          vpacket_capacity: int = 0, pool_w=None,
                          last_interaction: bool = False,
                          tracker_length: int = 0,
                          max_events: int = MAX_EVENTS,
                          line_estimators: bool = True,
                          progress=None) -> TransportOutput:
    """K1 on a pool of N packets split into D = len(devices) shards.

    Shard d runs packets [d N/D, (d+1) N/D) on ``devices[d]`` with the
    tables copied there (once per distinct device) and ``ceil(
    vpacket_capacity / D)`` spawn-record rows.  Returns one
    ``TransportOutput`` on ``devices[0]``: the estimators, the summary and
    the record counts summed over the shards, the per-packet rows in pool
    order, and the kept spawn records of each shard in shard order (so
    ``n_vp_records`` counts only kept rows and the attempts past each
    shard's capacity show as ``vp_count`` above it).  With
    ``line_estimators`` False no shard allocates or writes a line difference
    array, and the result's is empty.  ``progress(n)``, where given, is
    called with the shard's N/D packets after each shard's launch is
    queued (no host sync).  Raises when N is not a multiple of D, as the
    JAX package does.
    """
    devices = packet_devices(devices)
    parts = _sharded_chunk(
        tables, pool_mu, pool_nu, key, devices, nu_window=nu_window,
        vpacket_capacity=vpacket_capacity, pool_w=pool_w,
        last_interaction=last_interaction, tracker_length=tracker_length,
        max_events=max_events, line_estimators=line_estimators,
        progress=progress)
    with tracing.span("tardis.shard_reduce"), _on(devices[0]), \
            tracing.launch(_final_reduce, "shard_reduce"):
        out = _final_reduce(parts, devices[0])
    if tracing.recording():
        tracing.count("shard.shards", len(devices))
        # the kept records' count, read by the reduce already
        tracing.count("shard.peer_bytes", sum(
            _nbytes(*(getattr(p, f) for f in SUM_FIELDS + CAT_FIELDS),
                   p.vp_records[:p.n_vp_records]
                   if p.vp_records.shape[0] else None)
            for p, d in zip(parts, devices) if d != devices[0]))
    return out


def _nbytes(*items) -> int:
    """The bytes of the tensors in ``items``: tensors, tables dataclasses
    (their nested tables included), tuples of tensors, or None."""
    total = 0
    for x in items:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, tuple):
            total += _nbytes(*x)
        elif dataclasses.is_dataclass(x):
            total += _nbytes(*(getattr(x, f.name)
                              for f in dataclasses.fields(x)))
    return total


def _sharded_chunk(tables: TransportTables, pool_mu, pool_nu, key, devices,
                   *, vpacket_capacity: int = 0, pool_w=None, progress=None,
                   **options) -> list[TransportOutput]:
    """Every shard's K1 launch, as ``run_transport_sharded`` describes
    them, each on its device (``options``: the rest of
    ``transport_loop``'s); returns the shards' outputs, not yet
    reduced."""
    n_dev = len(devices)
    N = pool_mu.shape[0]
    if N % n_dev:
        raise ValueError(f"n_packets={N} not divisible by {n_dev} devices")
    n_local = N // n_dev
    capacity = -(-vpacket_capacity // n_dev)
    on_device = {}
    parts = []
    for d, device in enumerate(devices):
        sl = slice(d * n_local, (d + 1) * n_local)
        with tracing.span("tardis.shard_tables"):
            peer = device != devices[0]
            if device not in on_device:
                on_device[device] = tables.to(device)
                if peer and tracing.recording():
                    tracing.count("shard.peer_bytes", _nbytes(tables))
            mu, nu, w = (None if x is None
                         else x[sl].to(device, non_blocking=True)
                         for x in (pool_mu, pool_nu, pool_w))
            if peer and tracing.recording():
                tracing.count("shard.peer_bytes", _nbytes(mu, nu, w))
        with _on(device):
            parts.append(transport_loop(
                on_device[device], mu, nu, key, vpacket_capacity=capacity,
                pool_w=w, pid_offset=d * n_local, **options))
        if progress is not None:
            progress(n_local)
    return parts


def _final_reduce(parts: list[TransportOutput],
                  device: torch.device) -> TransportOutput:
    """The shards' outputs as one, on ``device``: SUM_FIELDS summed in
    shard order (an empty field, such as the line difference array of a
    run without line estimators, stays empty), CAT_FIELDS and the kept
    spawn records concatenated in shard order."""
    def here(x):
        return x.to(device, non_blocking=True)

    fields = {}
    for name in SUM_FIELDS:
        total = here(getattr(parts[0], name))
        for p in parts[1:]:
            total = total + here(getattr(p, name))
        fields[name] = total
    for name in CAT_FIELDS:
        fields[name] = torch.cat([here(getattr(p, name)) for p in parts])
    if parts[0].vp_records.shape[0]:
        # reading the counts waits for every shard, all launched by now
        fields["vp_records"] = torch.cat(
            [here(p.vp_records[:p.n_vp_records]) for p in parts])
    else:
        fields["vp_records"] = here(parts[0].vp_records)
    return TransportOutput(**fields)


_final_reduce.launches_by_variant = {}  # "shard_reduce": reduces recorded
