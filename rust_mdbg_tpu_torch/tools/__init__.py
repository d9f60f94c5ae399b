"""Pipeline tooling subcommands (the reference's second binary + utils/ scripts).

Dispatch table for `python -m rust_mdbg_tpu_torch <tool> ...`.  The JAX
package's `quality-n50` is not ported yet: the CLI refuses it before it
gets here.
"""

from __future__ import annotations


def dispatch(name: str, argv: list[str]) -> int:
    if name == "to-basespace":
        from .to_basespace import main

        return main(argv)
    if name == "gfa-asm":
        from .gfa_asm import main

        return main(argv)
    if name == "magic-simplify":
        from .magic_simplify import main

        return main(argv)
    if name == "simplify-meta":
        from .magic_simplify import main

        return main(argv + ["--meta"])
    if name == "multik":
        from .multik import main

        return main(argv)
    if name == "gfa2fasta":
        from .gfa2fasta import main

        return main(argv)
    if name == "gfa-complete":
        from .complete_gfa import main

        return main(argv)
    if name == "hpc-compress":
        from .hpc_compress import main

        return main(argv)
    if name == "gfa-strip":
        from .hpc_compress import main_strip

        return main_strip(argv)
    if name == "synth-reads":
        from ..experiments.synth import main

        return main(argv)
    if name == "ec-scale":
        from ..experiments.ec_scale import main

        return main(argv)
    if name == "extreme-simplify":
        from .extreme_view import main

        return main(argv)
    if name == "break-loops":
        from .gfa_break_loops import main

        return main(argv)
    raise SystemExit(f"unknown tool: {name}")
