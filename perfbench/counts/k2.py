"""K2, flash-decode attention of one query token a sequence over its cache
(``decode_partial_kernel`` then ``decode_combine_kernel``, one launch).

At (B sequences, H query heads, KVH cache heads, D head size, S valid cache
rows): a multiply-add for q.k and for p.v at every head and row, 4 B H S D
operations; bytes: q read and the output written (``q_bytes`` each), the S
valid rows of K and V read (``kv_bytes`` each; rows past the length are not
read), the B lengths.  The bound is the larger of bytes over HBM bandwidth
and operations over the float32 rate.
"""
F32_FLOPS = 67e12
HBM = 3.35e12

KERNELS = ("decode_partial_kernel", "decode_combine_kernel")


def work(b: int, h: int, kvh: int, d: int, s: int, q_bytes: int = 2, kv_bytes: int = 4):
    ops = 4.0 * b * h * s * d
    nbytes = 2.0 * b * h * d * q_bytes + 2.0 * b * s * kvh * d * kv_bytes + 4.0 * b
    return ops, nbytes


def bound_s(b, h, kvh, d, s, q_bytes=2, kv_bytes=4) -> float:
    ops, nbytes = work(b, h, kvh, d, s, q_bytes, kv_bytes)
    return max(ops / F32_FLOPS, nbytes / HBM)
