"""The traced window: ``torch.profiler`` (CUPTI) over the window's calls,
reduced to device operations, the layer spans that launched them, the
device's busy time and its idle gaps.

The reduction reads the profiler's raw events and not its function-event
tree, whose post-processing grows with the number of events.  A device
operation belongs to every ``osnbench.<layer>`` span whose host interval
holds the runtime call that launched it (matched by correlation id).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import torch

from osnbench.spans import PREFIX


def start(cuda: bool = True) -> "torch.profiler.profile":
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def warm_up(device) -> None:
    """One short traced region, so that CUPTI's start-up falls in set-up."""
    prof = start()
    torch.ones(1024, device=device).sum().item()
    prof.stop()


def _is_device(ev) -> bool:
    return ev.device_type() != torch.autograd.DeviceType.CPU


def reduce(prof) -> Dict:
    """Device ops (name, start_ns, dur_ns, spans), span intervals by layer,
    the union of device intervals (busy ns) and the idle gaps between them,
    over the whole traced region (the profiler runs for the window alone)."""
    events = prof.profiler.kineto_results.events()
    launch_ns: Dict[int, int] = {}
    spans: Dict[str, List[Tuple[int, int]]] = {}
    device = []
    for ev in events:
        name = ev.name()
        if _is_device(ev):
            # The profiler also draws each user range on the device's
            # timeline; those are not device work.
            if not (ev.is_user_annotation() or name.startswith(PREFIX)):
                device.append(ev)
            continue
        if name.startswith(PREFIX):
            spans.setdefault(name[len(PREFIX):], []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        elif name.startswith("cu") and ev.correlation_id():
            launch_ns[ev.correlation_id()] = ev.start_ns()
    for v in spans.values():
        v.sort()
    starts = {k: [s for s, _ in v] for k, v in spans.items()}

    def owners(t: Optional[int]) -> Tuple[str, ...]:
        if t is None:
            return ()
        out = []
        for layer, iv in spans.items():
            i = bisect.bisect_right(starts[layer], t) - 1
            if i >= 0 and iv[i][1] >= t:
                out.append(layer)
        return tuple(sorted(out))

    ops = []
    for ev in device:
        if ev.duration_ns() > 0:
            ops.append((ev.name(), ev.start_ns(), ev.duration_ns(),
                        owners(launch_ns.get(ev.correlation_id()))))
    ops.sort(key=lambda o: o[1])
    busy, gaps, cur = 0, [], None
    for name, s, dur, _ in ops:
        e = s + dur
        if cur is None:
            cur = [s, e, name]
            continue
        if s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((s - cur[1], cur[1], cur[2], name))
            cur = [s, e, name]
        elif e > cur[1]:
            cur[1], cur[2] = e, name
    if cur is not None:
        busy += cur[1] - cur[0]
    return {"ops": ops, "spans": spans, "busy_ns": busy, "gaps": gaps,
            "owners": owners}


def breakdown(red: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the layer span the host was in when the gap
    began and the operations around it."""
    by_name: Dict[str, int] = {}
    for name, _, dur, _ in red["ops"]:
        by_name[name] = by_name.get(name, 0) + dur
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(red["gaps"], key=lambda g: -g[0])[:top]
    idle = []
    for length, at, before, after in gaps:
        host = "+".join(red["owners"](at)) or "outside the layer spans"
        idle.append([f"{host}: after {before[:60]} before {after[:60]}",
                     length / 1e9])
    return {"device_ops": [[n[:160], ns / 1e9] for n, ns in device_ops],
            "idle_gaps": idle}


def device_s(red: Dict, layer: str) -> float:
    """Seconds of device operations that ``layer``'s spans launched."""
    return sum(dur for _, _, dur, owners in red["ops"]
               if layer in owners) / 1e9
