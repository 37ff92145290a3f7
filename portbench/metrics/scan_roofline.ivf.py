"""scan_roofline.ivf: the IVF list scan (`ops.ivf_scan`) against its
roofline, in the traced window.

A call needs, once each: each distinct probed list's ids (all slots) and
the codes of its valid slots, the probes, the (Q, P, L) outputs, and the
32-byte table sectors its codes hit (per query over the union of its
probed lists when one table serves all probes, per (query, probe)
otherwise); and one operation a subspace for every valid code of every
(query, probe). Counted with pb.bounds as the port's smoke test counts
the same kernel. The device time is that of `scan_kernel`
(csrc/ivf_scan.cu).
"""
from pb import bounds
from pb.roofline import replay as _replay
from pb.roofline import share

NAMES = ("ivf_scan",)
KERNELS = r"::scan_kernel<"


def replay(run):
    ivf = run.system.index.ivf
    n_valid = (ivf.list_ids >= 0).sum(dim=1)
    mask = bounds.table_mask(ivf.list_ids, ivf.list_codes,
                             ivf.pq.codebooks.shape[1])

    def scan_cost(args, kw):
        luts, codes, list_ids, probes = args[:4]
        width = codes.shape[2] * codes.element_size()
        nbytes = (bounds.table_bytes(mask, probes, luts.shape[1] > 1)
                  + bounds.scan_bytes(list_ids, n_valid, width, probes,
                                      kw["L"], 0))
        return nbytes, bounds.scanned_codes(n_valid, probes) * luts.shape[2]

    _replay(run, {"ivf_scan": scan_cost})


def read(run):
    return share(run, NAMES, KERNELS)
