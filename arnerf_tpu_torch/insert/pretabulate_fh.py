"""Write the SG hemisphere-integral table F(lambda, theta_d) ahead of its
first use (port of arnerf_tpu/insert/pretabulate_fh.py; the reference's
insert/pretabulate_fh.py integrates it with scipy's dblquad for hours,
sg_shadow.compute_fh_table's vectorised quadrature takes seconds):

  python -m arnerf_tpu_torch.insert.pretabulate_fh [--out PATH]

writes the full-size table to sg_shadow.FH_CACHE (the file the first SSDF
load would otherwise compute) through get_fh_table's atomic write, and
prints its shape, path and seconds.
"""

import argparse
import sys
import time

from .sg_shadow import FH_CACHE, compute_fh_table, write_fh_table


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(FH_CACHE))
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    t0 = time.perf_counter()
    tab = compute_fh_table()
    write_fh_table(tab, args.out)
    seconds = time.perf_counter() - t0
    print(f"saved {tab.shape} table -> {args.out} in {seconds:.2f} s",
          flush=True)
    return {"shape": tab.shape, "path": args.out, "seconds": seconds}


if __name__ == "__main__":
    main()
