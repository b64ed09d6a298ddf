"""How many CTAs of a thread-block cluster run one matrix function: the
launch plan of the kernels that split each matrix over a cluster with
`csrc/team.cuh` (#4 `csrc/expm_frechet.cu`, #7 `csrc/cru_scan_bwd.cu`)."""

from __future__ import annotations

from fractions import Fraction

import torch

CLUSTER_SIZES = (1, 2, 4)  # CTAs a matrix may take: 64 / C rows each


def cluster_size(B: int, active: dict) -> int:
    """The cluster size at batch B, from `active` {C: clusters of C CTAs
    the card holds at once}: the C whose waves, ceil(B / active[C]), cost
    the least at 1/C of a one-CTA cluster's time each (a matrix's products
    split over C CTAs); the smaller C on a tie, since every product then
    pays fewer cluster barriers and copies. An H100 holds 132, 66 and 30
    clusters of 1, 2 and 4 CTAs of these kernels (a cluster stays inside
    one GPC), so B 32 takes C = 2: clusters of 4 would run in two waves."""
    if B <= 0:
        return 1
    costs = {C: Fraction(-(-B // n), C) for C, n in active.items() if n > 0}
    if not costs:
        raise ValueError(f"no cluster size fits on the card ({active})")
    return min(costs, key=lambda C: (costs[C], C))


_active: dict = {}  # (kernel, device index, shape key) -> {C: resident clusters}


def cluster_plan(B: int, device, kernel: str, key: tuple, count) -> dict:
    """The launch of `kernel` at batch B on a CUDA device: cluster size C,
    the clusters of C CTAs the card holds at once (count(C), the kernel's
    cudaOccupancyMaxActiveClusters at shape `key`, asked once per device
    and key), and the SMs that hold a CTA (one CTA an SM: its shared
    memory takes most of one)."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    cache_key = (kernel, index, key)
    if cache_key not in _active:
        with torch.cuda.device(index):
            _active[cache_key] = {C: count(C) for C in CLUSTER_SIZES}
    active = _active[cache_key]
    C = cluster_size(B, active)
    return {"cluster": C, "active_clusters": active[C], "active_by_size": dict(active),
            "ctas": B * C, "sms_in_use": min(B, active[C]) * C}
