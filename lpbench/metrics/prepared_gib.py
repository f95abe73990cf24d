"""prepared_gib (GiB): the bytes held by the contexts that the kernel sets'
``prepare`` returned in the program's last entry call, each set's context
once (``pycllp_tpu_torch.solvers.hsd.PREPARED_BYTES``: (set name, bytes of
its tensors, each storage once) → prepares, counted at each graph replay
too).  On a shared A: the narrow and crossover sets' f32 W = A∘A (m², n),
the wide set's f64 W and its Ozaki operands (packed slices and scales, of
W, A and Aᵀ), the copies of A and A²; on a per-instance A, the copies of A
and A².  Nothing to read where the program has no such counter or prepared
nothing."""

from lpbench import program


def read(run):
    try:
        prepared = program.resolve("pycllp_tpu_torch.solvers.hsd.PREPARED_BYTES")
    except AttributeError:
        return None
    held = sum(nbytes for (_, nbytes), n in dict(prepared).items() if n > 0)
    return held / 2**30 if held > 0 else None
