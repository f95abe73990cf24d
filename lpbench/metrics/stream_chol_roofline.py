"""stream_chol_roofline (%): the float streaming factor's share of its bound.

The bound of one launch on B lanes of m x m is the larger of its operations
at the H100's FP32 peak and its bytes at HBM's: B·m³/3 FLOPs at 66.9 TFLOP/s,
and each lane's lower triangle read once and written once, B·m(m+1)/2·4·2
bytes at 3.35 TB/s.  The bound is weighted by the launches of each shape the
program recorded (``pycllp_tpu_torch.ops.batchlast.STREAM_LAUNCHES``,
("chol", "f32", m, B, 1) keys), and divided by the traced stretch's mean
device time a launch of ``chol_bl_kernel<float>``.  Nothing to read where
the program records no shapes or the stretch ran no such launch."""

from lpbench import harness, program

FP32_FLOPS = 66.9e12  # H100 SXM, FP32 (no tensor cores), per second
HBM_BYTES = 3.35e12  # H100 SXM HBM3, per second


def bound_s(m: int, B: int) -> float:
    """Seconds of one float factor launch at the card's bound."""
    return max(B * m**3 / 3 / FP32_FLOPS, B * m * (m + 1) / 2 * 4 * 2 / HBM_BYTES)


def mean_bound_s(shapes) -> float | None:
    """The launch-weighted mean bound over the float factor shapes of a
    ``STREAM_LAUNCHES`` counter."""
    f32 = {key: n for key, n in shapes.items() if key[:2] == ("chol", "f32") and n > 0}
    if not f32:
        return None
    return sum(n * bound_s(key[2], key[3]) for key, n in f32.items()) / sum(f32.values())


def read(run):
    tr = run.trace
    if tr is None:
        return None
    try:
        shapes = program.resolve("pycllp_tpu_torch.ops.batchlast.STREAM_LAUNCHES")
    except AttributeError:
        return None
    bound = mean_bound_s(shapes)
    kind = harness.reader("stream_ms").stream_kind
    us = [e.end - e.start for e in tr.kernels if kind(e.name) == ("chol", "float")]
    if bound is None or not us:
        return None
    return 100.0 * bound / (sum(us) / len(us) / 1e6)
