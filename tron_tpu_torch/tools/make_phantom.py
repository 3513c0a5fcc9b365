"""Write a Shepp-Logan phantom .ra fixture with the reference's 5-D dims
(1, 1, n, n, 1), the synthesized stand-in for data/shepplogan.ra
(counterpart of `tron_tpu/tools/make_phantom.py`; numpy only):

    python -m tron_tpu_torch.tools.make_phantom sl.ra --n 64
"""

import argparse

import numpy as np

from tron_tpu_torch.io import ra_write
from tron_tpu_torch.phantom import shepp_logan


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("outfile")
    p.add_argument("--n", type=int, default=256)
    args = p.parse_args(argv)
    img = shepp_logan(args.n)  # (n, n) [y, x]
    # .ra dims (1, 1, nx, ny, 1): x fastest of the two image axes
    arr = img.T[None, None, :, :, None].astype(np.complex64)
    ra_write(arr, args.outfile)
    print(f"wrote {args.outfile} dims={arr.shape}")


if __name__ == "__main__":
    main()
