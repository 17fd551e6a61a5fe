"""Work of one call of each SOAP-coefficient kernel: a frozen copy of
``slot_counts`` / ``soap_work`` of the port's ``tools/soap_bench.py`` as
they stood when the benchmark was defined.

Bytes: what the function must read, once, and write, once: the mask byte
of every slot, the species of each kept slot, the coordinates of each kept
slot whose species is in the table, the radii, and the outputs (the
backward reads only the live m <= l cotangent channels and writes every
slot's gradient).  Operations: the full count for each live slot (d < rc),
the distance test for each other valid slot, nothing for a masked one.
"""

from __future__ import annotations

# a valid slot at or beyond rc costs only its distance test: scale by the
# radius (3), squared distance (5), sqrt, times the radius, compare
TEST_OPS = 11


def slot_counts(rvec, sidx, mask, radii, rc):
    """(valid, known, live): slots the mask keeps, those of them whose
    species is in the table, and those of these closer than rc."""
    S = radii.shape[0]
    keep = mask.bool()
    known = keep & (sidx >= 0) & (sidx < S)
    live = known & (rvec.norm(dim=-1) < rc)
    return tuple(int(t.sum().item()) for t in (keep, known, live))


def soap_work(rvec, sidx, mask, radii, lmax, nmax, rc):
    """((bytes, operations) of one forward call, the same of one backward
    call, (valid, live) slot counts)."""
    N, K, _ = rvec.shape
    S = radii.shape[0]
    esize = rvec.element_size()
    n_valid, n_known, n_live = slot_counts(rvec, sidx, mask, radii, rc)
    L = lmax + 1
    nf = nmax + 1
    CH = S * nf * L * L
    lm = L * (L + 1) // 2  # (l, m <= l) pairs
    # harmonics: P recursion (5 per m < l-1, 2 + 1 for m = l-1, l), C/S
    p_ops = sum(5 * max(l - 1, 0) + 3 for l in range(1, L)) + 6 * (L - 1)
    setup = 25 + nf
    fwd_slot = setup + p_ops + 2 * lm + 4 * nf * lm
    dp_ops = sum(24 * max(l - 1, 0) + 11 for l in range(1, L))
    # backward with the n-sum factored out of the angular work: per (l, m)
    # the four sums over n of cotangent x (f_n, d f_n) (8 nf), then once
    # Yr, Yi (2), the radial weight (4) and the three angular partials
    # (10 + 10 + 6); per slot the radial terms (6 nf), dC/dS (4 per m > 0)
    # and the radial weight times (x, y, z) (6)
    bwd_slot = (setup + 10 + p_ops + dp_ops + 6 * nf + lm * (8 * nf + 32)
                + 4 * (L - 1) + 6 + 3)
    tested = (n_valid - n_live) * TEST_OPS
    slot_in = N * K + n_valid * 4 + n_known * 3 * esize  # mask, sidx, rvec
    fwd_bytes = slot_in + S * esize + 2 * N * CH * esize
    bwd_bytes = slot_in + S * esize + 2 * N * S * nf * lm * esize + N * K * 3 * esize
    return ((fwd_bytes, n_live * fwd_slot + tested),
            (bwd_bytes, n_live * bwd_slot + tested), (n_valid, n_live))
