"""100 x (wall - CPU) / wall over the program's `pack` and `build` spans:
the share of that host work's time in which its thread could not run
(waiting for the interpreter lock or a core)."""

from portbench.spans import stall_pct


def read(ctx):
    return stall_pct(ctx, "pack", "build")
