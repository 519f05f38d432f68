"""A device mesh as an ordered list of torch devices, and its placements.

Counterpart of the JAX package's one-axis ``Mesh(devices, ("data",))``
(``lighthouse_tpu/parallel/*``).  The JAX package is single-controller: one
process drives every device of the mesh.  So is the port: one process
launches each shard's kernels on its shard's device, and

- ``P("data")`` placement is ``split``: contiguous slices, slice i copied
  to ``mesh[i]``;
- ``P()`` (replicated) is ``replicate``: one copy on each distinct device;
- ``lax.all_gather(..., tiled=True)`` is ``gather``: the shards' outputs
  copied to ``mesh[0]`` and stacked in shard order, where the replicated
  top step then runs once (every caller reads one replica).

A mesh may name one device more than once (the tests, ``chip_smoke.py``
and the dry run do, as the JAX package's tests use virtual CPU devices):
its shards then run one after another on that device.  The default mesh is
every visible card, rounded down to a power of two.
"""

from __future__ import annotations

from typing import Sequence

import torch

from lighthouse_tpu_torch.device import resolve_device


def check_mesh(devices: Sequence) -> list[torch.device]:
    """The mesh ``devices`` names, each entry resolved (``"cuda"`` to the
    current card's index).  Raises on an empty mesh, on one that mixes the
    CPU and CUDA, and on a CUDA entry without a card."""
    if isinstance(devices, (str, torch.device)) or len(devices) == 0:
        raise ValueError(f"a mesh is a non-empty list of devices, got {devices!r}")
    kinds = {torch.device(d).type for d in devices}
    if len(kinds) != 1:
        raise ValueError(f"a mesh must not mix device types: {[str(d) for d in devices]}")
    mesh = [resolve_device(d) for d in devices]
    if kinds == {"cuda"}:
        mesh = [d if d.index is not None else torch.device("cuda", torch.cuda.current_device())
                for d in mesh]
    return mesh


def device_mesh(n_devices: int | None = None, devices: Sequence | None = None
                ) -> list[torch.device]:
    """``devices`` (its first ``n_devices`` if given) as a mesh, or else the
    first ``n_devices`` visible cards (all by default) rounded down to a
    power of two, as ``epoch_mesh`` and ``msm_mesh`` of the JAX package
    choose.  Raises when no card is visible or fewer than asked for."""
    if devices is not None:
        mesh = check_mesh(devices)
        if n_devices is not None:
            if not 1 <= n_devices <= len(mesh):
                raise ValueError(f"{n_devices} devices asked of a mesh of {len(mesh)}")
            mesh = mesh[:n_devices]
        return mesh
    resolve_device("cuda")
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if not 1 <= n <= have:
        raise ValueError(f"{n} devices asked for, {have} cards visible")
    n = 1 << (n.bit_length() - 1)
    return [torch.device("cuda", i) for i in range(n)]


def rung_mesh(device: torch.device) -> list[torch.device]:
    """The mesh of a ``sharded`` rung (epoch pass, pubkey fold) for an entry
    point on ``device``: every visible card (``device_mesh()``) for a card,
    the CPU alone for the CPU."""
    return device_mesh() if device.type == "cuda" else [device]


def round_robin(n: int, device=None) -> list[torch.device]:
    """A mesh of ``n`` entries over the visible cards in turn (``cuda``) or
    the CPU ``n`` times: more entries than cards name a card again."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"a mesh needs at least one entry, got {n}")
    if dev.type == "cpu":
        return [dev] * n
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]


def distinct(mesh: Sequence[torch.device]) -> list[torch.device]:
    """The mesh's devices, each once, in mesh order."""
    return list(dict.fromkeys(mesh))


def bounds(n: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous row ranges of ``n`` rows over ``n_shards`` shards: each
    shard ceil(n / n_shards) rows, the last what remains (possibly none)."""
    per = -(-n // n_shards)
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(n_shards)]


def split(x: torch.Tensor, mesh: Sequence[torch.device]) -> list[torch.Tensor]:
    """``P("data")``: x [n, ...] with n a multiple of the mesh size -> slice
    i of n / len(mesh) rows on ``mesh[i]`` (a view where x already lies
    there)."""
    if x.shape[0] % len(mesh):
        raise ValueError(f"{x.shape[0]} rows do not split over a mesh of {len(mesh)}")
    per = x.shape[0] // len(mesh)
    return [x[i * per:(i + 1) * per].to(d) for i, d in enumerate(mesh)]


def replicate(x: torch.Tensor, mesh: Sequence[torch.device]) -> dict:
    """``P()``: {device: x on that device} over the mesh's distinct devices
    (x itself where it already lies)."""
    return {d: x.to(d) for d in distinct(mesh)}


def gather(shards: Sequence[torch.Tensor], mesh: Sequence[torch.device]) -> torch.Tensor:
    """``all_gather(tiled=True)``: the shards' outputs on ``mesh[0]``,
    concatenated in shard order."""
    return torch.cat([s.to(mesh[0]) for s in shards])


def synchronize(mesh: Sequence[torch.device]) -> None:
    """Wait for every card of the mesh (nothing to wait for on the CPU)."""
    for d in distinct(mesh):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
