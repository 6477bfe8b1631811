"""User-facing API with the names and conventions of the reference's
grtrans_batch.py, as grtrans_tpu/api.py keeps them: `Grtrans.run()` drives
the render directly and the post-processing methods follow
(calc_spec, convert_to_lum, convert_to_Jy, calc_centroid_size).  Results
are numpy arrays in the reference layout.
"""

import numpy as np
import torch

from grtrans_tpu_torch import constants as pc
from grtrans_tpu_torch.config import GrtransConfig
from grtrans_tpu_torch.io.binio import write_camera_bin
from grtrans_tpu_torch.io.fitsio import write_fits
from grtrans_tpu_torch.orchestrator import grtrans_run


class Grtrans:
    """Run and hold results.  Attributes as in grtrans_batch: ivals
    (npix, nvals, ncams), ab (npix, 2), freqs, nx, ny, spec."""

    def __init__(self, **kwargs):
        self.cfg = None
        if kwargs:
            self.set_inputs(**kwargs)

    def set_inputs(self, **kwargs):
        self.cfg = GrtransConfig(**kwargs)
        return self

    def run(self, device="cuda", chunk=None, model=None, **kwargs):
        """Render on `device` (run_pgrtrans, grtrans_batch.py:397-414).
        The default is the card; without one this raises rather than
        render on the CPU, which a caller asks for with device="cpu".
        chunk: pixels per block, see grtrans_run.  model: a fluid model
        already loaded on `device` (a GRMHD snapshot rendered many times,
        a time series built with append_slice); else it is loaded from
        fname / fargs."""
        if kwargs:
            self.set_inputs(**kwargs)
        if torch.device(device).type == "cuda" \
                and not torch.cuda.is_available():
            raise RuntimeError(
                f"Grtrans.run(device={device!r}): no CUDA device; pass "
                "device=\"cpu\" to render on the CPU")
        ivals, ab, freqs = grtrans_run(self.cfg, model, device=device,
                                       chunk=chunk)
        # the reference's (npix, nvals, ncams) layout
        self.ivals = np.ascontiguousarray(
            ivals.cpu().numpy().transpose(1, 2, 0))
        self.ab = np.ascontiguousarray(ab.cpu().numpy().T)      # (npix, 2)
        self.freqs = freqs
        self.nu = freqs
        self.nx, self.ny = self.cfg.nn[0], self.cfg.nn[1]
        self.nvals = self.cfg.nvals
        self.calc_spec(self.ivals.shape[2])
        return self

    run_pgrtrans = run

    def calc_spec(self, n):
        """Image -> spectrum integration with pixel areas; polarization
        fractions for nvals >= 4 (grtrans_batch.py:499-543)."""
        iv = self.ivals
        ab = self.ab
        if self.ny != 1:
            da = ab[self.ny, 0] - ab[0, 0]
            db = ab[1, 1] - ab[0, 1]
            spec = np.sum(iv, 0) * da * db          # (nvals, ncams)
            if self.nvals >= 4:
                self.lp = np.sqrt(spec[1] ** 2 + spec[2] ** 2) / spec[0]
                self.cp = spec[3] / spec[0]
                self.lpf = np.sum(np.sqrt(iv[:, 1] ** 2 + iv[:, 2] ** 2),
                                  0) * da * db / spec[0]
                self.cpf = np.sum(np.abs(iv[:, 3]), 0) * da * db / spec[0]
        else:
            # 1-D radial strip: annulus weighting 2 pi alpha d alpha
            da = ab[1, 0] - ab[0, 0]
            db = 0.0
            spec = np.empty((n, self.nvals))
            for i in range(n):
                for j in range(self.nvals):
                    spec[i, j] = np.sum(iv[:, j, i] * ab[:, 0]) \
                        * da * 2.0 * np.pi
        self.spec = spec
        self.da, self.db = da, db
        return spec

    def convert_to_lum(self):
        """Isotropic luminosity units (grtrans_batch.py:545-553)."""
        fac = 4.0 * np.pi * pc.lbh(self.cfg.mbh) ** 2
        self.spec = self.spec * fac
        self.ivals = self.ivals * fac * self.da * self.db
        return self.spec

    def convert_to_Jy(self, D):
        """Flux density at distance D [cm] (grtrans_batch.py:555-562)."""
        fac = (pc.lbh(self.cfg.mbh) ** 2 / D ** 2) * 1e23
        self.ivals = self.ivals * fac * self.da * self.db
        self.spec = self.spec * fac
        return self.spec

    def calc_centroid_size(self):
        """Image moments: centroid, semi-axes, orientation
        (grtrans_batch.py:566-587)."""
        iv = self.ivals
        ab = self.ab
        M00 = np.sum(iv[:, 0], 0)
        M10 = np.einsum("pk,p->k", iv[:, 0], ab[:, 0])
        M01 = np.einsum("pk,p->k", iv[:, 0], ab[:, 1])
        M20 = np.einsum("pk,p->k", iv[:, 0], ab[:, 0] ** 2)
        M02 = np.einsum("pk,p->k", iv[:, 0], ab[:, 1] ** 2)
        M11 = np.einsum("pk,p->k", iv[:, 0], ab[:, 0] * ab[:, 1])
        xcen = M10 / M00
        ycen = M01 / M00
        mu20 = M20 / M00 - xcen ** 2
        mu11 = M11 / M00 - xcen * ycen
        mu02 = M02 / M00 - ycen ** 2
        theta = 0.5 * np.arctan(2 * mu11 / (mu20 - mu02))
        fac = np.sqrt(4 * mu11 ** 2 + (mu20 - mu02) ** 2)
        self.xcen, self.ycen, self.theta = xcen, ycen, theta
        self.amax = np.sqrt((mu20 + mu02 + fac) / 2.0)
        self.amin = np.sqrt((mu20 + mu02 - fac) / 2.0)
        return xcen, ycen

    def write_output(self, path, fmt="bin"):
        """Write the cameras in the reference's raw binary layout, or with
        fmt="fits" as FITS that carries every run parameter on each
        camera (camera.f90:219-305)."""
        ivals_list = [self.ivals[:, :, i] for i in range(self.ivals.shape[2])]
        if fmt == "fits":
            write_fits(path, self.ab, ivals_list,
                       self.cfg.camera_key_dicts()[:len(ivals_list)])
            return
        if fmt != "bin":
            raise ValueError(f"write_output(fmt={fmt!r}): \"bin\" or \"fits\"")
        freqs = np.atleast_1d(self.freqs)
        keys = [[float(freqs[i % len(freqs)])]
                for i in range(len(ivals_list))]
        write_camera_bin(path, self.ab, ivals_list, keys, self.nx, self.ny)
