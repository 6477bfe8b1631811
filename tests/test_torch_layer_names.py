"""The layer API's names grtrans_tpu exports, in the port: each
sub-package's re-exports (grtrans_tpu/*/__init__.py), the cumulative
optical depth emis/framework.calc_opt_depth, fluid/base.get_fluid_vars and
convert_fluid_vars, and the KORAL3D region names Koral3DDisk, Koral3DTopJet
and Koral3DBotJet; held against grtrans_tpu's at 1e-12 of max|value|
(measured 3.1e-16 for the optical depth, 4.5e-16 for the fluid)."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grtrans_tpu.emis import framework as jframework
from grtrans_tpu.fluid import base as jbase
from grtrans_tpu.fluid import koral as jkoral
from grtrans_tpu_torch import obs
from grtrans_tpu_torch.emis import framework as tframework
from grtrans_tpu_torch.fluid import base as tbase
from grtrans_tpu_torch.fluid import koral as tkoral
from grtrans_tpu_torch.testing import grmhd_dump as gd

from test_torch_grmhd import A, rays

torch.set_num_threads(1)   # the suite runs in parallel worker processes

REPO = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("emis", "fluid", "geodesics", "geometry", "integrate", "io",
               "ops", "parallel")


def _exported(package):
    """The names package/__init__.py imports (a package's attributes also
    hold whatever submodule another test imported)."""
    tree = ast.parse((REPO / package / "__init__.py").read_text())
    return {a.asname or a.name for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for a in node.names}


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_subpackage_exports_the_names_of_grtrans_tpu(name):
    """Every name grtrans_tpu.<name> exports, grtrans_tpu_torch.<name>
    exports too (ops also exports quad_gather, which builds nothing on
    import)."""
    jax_names = _exported(f"grtrans_tpu/{name}")
    assert jax_names <= _exported(f"grtrans_tpu_torch/{name}")
    port = importlib.import_module(f"grtrans_tpu_torch.{name}")
    for n in jax_names:
        getattr(port, n)
    if name == "ops":
        assert callable(port.quad_gather.quad_gather)
        assert obs.counters()["quad_gather.launches"] >= 0


def test_calc_opt_depth_matches_jax():
    rng = np.random.default_rng(0)
    lam = np.cumsum(rng.uniform(0.01, 1.0, (6, 40)), axis=-1)
    K = rng.standard_normal((6, 40, 7))
    for indx in (0, 4, 6):
        ours = tframework.calc_opt_depth(torch.from_numpy(lam),
                                         torch.from_numpy(K), indx).numpy()
        ref = np.asarray(jframework.calc_opt_depth(jnp.asarray(lam),
                                                   jnp.asarray(K), indx))
        np.testing.assert_allclose(ours, ref, rtol=0.0,
                                   atol=1e-12 * np.abs(ref).max())


def test_fluid_helpers_and_koral3d_region_names_match_jax():
    """get_fluid_vars / convert_fluid_vars on a KORAL3D snapshot, and each
    region's grtrans_tpu class name, against grtrans_tpu's (1e-12 of each
    field's max|value|)."""
    dump = gd.koral_dump(24, 12, 6, seed=8)
    _, geo = rays()
    sp = dict(mbh=4.3e6, nfac=1e8, mdot=1e8, mu=0.25, gmin=10.0)
    for name in ("Koral3D", "Koral3DDisk", "Koral3DTopJet",
                 "Koral3DBotJet"):
        ours = getattr(tkoral, name)(dump=dump, device="cpu")
        ref = getattr(jkoral, name)(dump=dump)
        tfv = tbase.get_fluid_vars(ours, geo.x, geo.k, A)
        jfv = jbase.get_fluid_vars(ref, jnp.asarray(geo.x.numpy()),
                                   jnp.asarray(geo.k.numpy()), A)
        tei = tbase.convert_fluid_vars(ours, tfv, tbase.SourceParams(**sp))
        jei = jbase.convert_fluid_vars(ref, jfv, jbase.SourceParams(**sp))
        for got, want in ((tfv.rho, jfv.rho), (tfv.u, jfv.u),
                          (tfv.bmag, jfv.bmag), (tei.ncgs, jei.ncgs),
                          (tei.tcgs, jei.tcgs), (tei.bcgs, jei.bcgs)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0.0,
                                       atol=1e-12 * np.abs(want).max())
