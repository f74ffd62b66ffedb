"""How far the order of a decode score's f32 dot product moves the output.

    python scripts/decode_dot_order.py [--seed N]

The verify kernel (``verify_attention.cu``) sums a key's 128 products q.k
in turn; the split decode kernel (``decode_attention.cu``) sums 8 a lane
(columns 4 * sub.. and 64 + 4 * sub..) and then the 16 lanes by a
butterfly.  This scores the same bf16 keys both ways in f32, finishes the
softmax and the weighted sum of bf16 values in float64, and prints the
largest difference of the two outputs over the serving path's 4 slots
(positions 543/400/300/64) x 12 query heads: the part of the T = 1
verify-vs-decode difference that the scores' order alone explains.  Runs
on the CPU; numpy only.
"""

import argparse

import numpy as np

D = 128
POS = (543, 400, 300, 64)
HEADS = 12


def bf16(x: np.ndarray) -> np.ndarray:
    """f32 values cut to bf16 (truncated: any bf16 values will do)."""
    return (x.astype(np.float32).view(np.uint32) & 0xFFFF0000).view(np.float32)


def in_turn(q, k):
    s = np.zeros(k.shape[0], np.float32)
    for c in range(D):
        s = np.float32(s + q[c] * k[:, c])
    return s


def lanes_then_butterfly(q, k):
    lanes = []
    for sub in range(D // 8):
        s = np.zeros(k.shape[0], np.float32)
        for c in np.r_[4 * sub:4 * sub + 4, D // 2 + 4 * sub:D // 2 + 4 * sub + 4]:
            s = np.float32(s + q[c] * k[:, c])
        lanes.append(s)
    while len(lanes) > 1:                     # xor offsets 8, 4, 2, 1
        h = len(lanes) // 2
        lanes = [np.float32(lanes[i] + lanes[i + h]) for i in range(h)]
    return lanes[0]


def out(s, v):
    s = s.astype(np.float64) * D ** -0.5
    p = np.exp(s - s.max())
    return (p @ v.astype(np.float64)) / p.sum()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    rng = np.random.default_rng(ap.parse_args().seed)
    worst = 0.0
    for pos in POS:
        for _ in range(HEADS):
            q = rng.standard_normal(D).astype(np.float32)
            k, v = (bf16(rng.standard_normal((pos + 1, D))) for _ in "kv")
            worst = max(worst, np.abs(out(in_turn(q, k), v)
                                      - out(lanes_then_butterfly(q, k), v)).max())
    print(f"max |o(in turn) - o(lanes, butterfly)| over {len(POS) * HEADS} rows: "
          f"{worst:.3e}")


if __name__ == "__main__":
    main()
