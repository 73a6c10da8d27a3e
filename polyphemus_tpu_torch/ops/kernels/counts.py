"""The kernel wrappers' launch counts: the kernel launches (not plain-path
calls) in this process since the counts were last reset, in one dict keyed
by (kernel, S, K): the kernel's name (`gcl_eval`, `chord_tail_bf16`, ...),
the steps S of a bar of its input (32 at resolution 8) and the eval GCL
layers K chained in the launch (1 for every other kernel). A wrapper adds
one where it launches its kernel, and nowhere else; `kernels.launch_counts`
names the counts as the CLIs print them."""

from __future__ import annotations

launches: dict[tuple[str, int, int], int] = {}


def count(kernel: str, s: int = 32, k: int = 1) -> None:
    """Count one launch of `kernel` over bars of 4 x s cells, k layers."""
    key = (kernel, s, k)
    launches[key] = launches.get(key, 0) + 1


def total(kernel: str, s: int = 32, k: int | None = None) -> int:
    """The launches of `kernel` over bars of 4 x s cells, of k layers (of
    any number with k None)."""
    return sum(n for (name, s_, k_), n in launches.items()
               if name == kernel and s_ == s and k in (None, k_))


def reset() -> None:
    """Every count to 0."""
    launches.clear()


def since(before: dict) -> dict:
    """The launches since the snapshot `before` (a copy of `launches`), by
    key, those keys only whose count moved."""
    return {key: n - before.get(key, 0) for key, n in launches.items()
            if n != before.get(key, 0)}


def restore(saved: dict) -> None:
    """The counts back to the snapshot `saved` (launches made to hold a
    kernel against its plain version do not count)."""
    launches.clear()
    launches.update(saved)
