"""The logical axes and the sharding rules of the port
(``repro_torch.launch.shardings``, ``input_specs``, ``Model.param_axes``,
``cache_specs``, ``cross_kv_specs``) against the reference's, entry for
entry.

The reference's side runs in one subprocess on abstract meshes
(``compat.abstract_mesh``): for every arch of ``ARCHS`` x the modes
``train``, ``train_dp`` and ``serve`` x the meshes (16, 16), (2, 16, 16),
(2, 2) and (1, 4), the parameters' specs, the optimizer state's (ZeRO-1),
the decode caches' at decode_32k and long_500k, and the inputs' batch
specs; and per arch ``param_axes()``, the caches' and cross caches' axes
and shapes, and ``input_specs`` of every shape. The port's leaves are
matched to the reference's through ``Model.param_paths()``: a segment's
per-layer tensor has the reference's spec less its leading ``layers``
entry.

One deviation is stated, not hidden: ZeRO-1 picks the largest replicated
dim that divides ``data``. The reference picks it on its stacked leaf, so
for a leaf of small dims (hymba's ``beta``, the vision model's ``gate``)
it may pick the ``layers`` dim; the port holds a tensor a layer and picks
among that tensor's own dims. Those leaves are counted and checked to be
exactly the ones whose reference spec puts ``data`` on ``layers``.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import functools
import tempfile

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import partition, shardings  # noqa: E402
from repro_torch.launch.input_specs import SHAPES, input_specs  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import axes_maker, shape_maker  # noqa: E402

import _torch_mesh_harness as harness  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model"))]
MODES = ("train", "train_dp", "serve")


@pytest.fixture(scope="module")
def ref():
    with tempfile.TemporaryDirectory() as tmp:
        handle = harness.start_reference(
            [{"name": "specs", "kind": "specs", "meshes": MESHES}], tmp,
            devices=1)
        return harness.reference_results(handle)["specs"]


@functools.lru_cache(maxsize=None)
def model_of(arch):
    return build_model(get_config(arch), "meta")


def flat(tree, path=()):
    """{path string: leaf} over dicts, lists and tuples down to tensors
    (and any other leaf)."""
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, path + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, path + (i,)))
    else:
        out[harness.path_key(path)] = tree
    return out


def flat_axes(shape_tree, axes_tree):
    """{path: axes} read beside the shape tree's tensors."""
    keys = flat(shape_tree)
    out = {}

    def at(tree, key):
        for p in key.split("/"):
            tree = tree[int(p)] if isinstance(tree, (list, tuple)) \
                else tree[p]
        return tree

    for k in keys:
        out[k] = tuple(at(axes_tree, k))
    return out


def mkey(shape):
    return "x".join(map(str, shape))


def per_layer(model):
    """name -> (reference path string, layer or None)."""
    return {n: (harness.path_key(p), layer)
            for n, (p, layer) in model.param_paths().items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_reference(ref, arch):
    model = model_of(arch)
    axes = model.param_axes()
    want = ref[(arch, "axes")]
    shapes = ref[(arch, "shapes")]
    stand = model.abstract_params()
    seen = set()
    for name, (path, layer) in per_layer(model).items():
        w, shp = want[path], shapes[path]
        if layer is not None:
            assert w[0] == "layers", (arch, name, w)
            w, shp = w[1:], shp[1:]
        assert axes[name] == w, (arch, name, axes[name], w)
        assert tuple(stand[name].shape) == shp, (arch, name)
        seen.add(path)
    assert seen == set(want), (arch, set(want) ^ seen)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_shape,names", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(ref, arch, mesh_shape, names,
                                             mode):
    model = model_of(arch)
    mesh = Mesh(mesh_shape, names)
    layout = partition.param_layout(model, mesh, mode)
    want = ref[(arch, mkey(mesh_shape), mode, "params")]
    want_opt = ref[(arch, mkey(mesh_shape), mode, "opt")]
    layers_zero = set()
    for name, (path, layer) in per_layer(model).items():
        w, wo = want[path], want_opt[path]
        if layer is not None:
            assert w[0] is None, (arch, name, w)
            w = w[1:]
            if wo[0] == "data":
                # ZeRO-1 on the reference's stacked layers dim (docstring):
                # the layers dim won, as no other replicated dim that
                # divides is larger
                n_layers = ref[(arch, "shapes")][path][0]
                assert all(e is not None or d % mesh.shape["data"]
                           or d <= n_layers
                           for e, d in zip(w, layout.shapes[name])), name
                layers_zero.add(path)
                continue
            wo = wo[1:]
        assert layout.specs[name] == w, (arch, name, layout.specs[name], w)
        assert layout.opt[name] == wo, (arch, name, layout.opt[name], wo)
    opt = shardings.opt_state_pspecs(layout.specs, model.abstract_params(),
                                     mesh)
    assert (opt.master is not None) == \
        ref[(arch, mkey(mesh_shape), mode, "master")]
    assert opt.step == ()
    # where data has one rank the layers dim is as good as any
    assert mesh.shape.get("data", 1) == 1 or len(layers_zero) <= 2 * len(
        model.plan), sorted(layers_zero)


@pytest.mark.parametrize("mesh_shape,names", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(ref, arch, mesh_shape, names):
    model = model_of(arch)
    cfg = model.cfg
    mesh = Mesh(mesh_shape, names)
    for shape in ("decode_32k", "long_500k"):
        S, B = SHAPES[shape]["seq"], SHAPES[shape]["batch"]
        ctx = S + cfg.n_meta_tokens
        stand = model.cache_specs(shape_maker(cfg.activation_dtype), B, ctx)
        got = flat_axes(stand, partition.cache_pspecs(model, mesh, B, ctx))
        want = ref[(arch, mkey(mesh_shape), shape, "caches")]
        assert got == want, (arch, shape, set(got.items()) ^
                             set(want.items()))
    for shape in SHAPES:
        specs, _ = input_specs(cfg, model, shape)
        batch = {k: v for k, v in specs.items()
                 if k in ("tokens", "labels", "token", "index")}
        got = shardings.batch_pspecs(batch, mesh)
        assert got == ref[(arch, mkey(mesh_shape), shape, "batch")], \
            (arch, shape)


def _dtype(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_cross_and_input_specs_match_reference(ref, arch):
    model = model_of(arch)
    cfg = model.cfg
    mk_s, mk_a = shape_maker(cfg.activation_dtype), axes_maker()
    cs = model.cache_specs(mk_s, 2, 64)
    assert {k: tuple(v.shape) for k, v in flat(cs).items()} == \
        ref[(arch, "cache_shapes")]
    assert flat_axes(cs, model.cache_specs(mk_a, 2, 64)) == \
        ref[(arch, "cache_axes")]
    xs = model.cross_kv_specs(mk_s, 2, 16)
    assert (xs is None) == ((arch, "cross_shapes") not in ref)
    if xs is not None:
        assert {k: tuple(v.shape) for k, v in flat(xs).items()} == \
            ref[(arch, "cross_shapes")]
        assert flat_axes(xs, model.cross_kv_specs(mk_a, 2, 16)) == \
            ref[(arch, "cross_axes")]
    for shape in SHAPES:
        specs, axes = input_specs(cfg, model, shape)
        got = {k: (tuple(v.shape), _dtype(v)) for k, v in flat(specs).items()}
        assert got == ref[(arch, shape, "input_shapes")], (arch, shape)
        assert flat_axes(specs, axes) == ref[(arch, shape, "input_axes")], \
            (arch, shape)


def test_cells_match_reference(ref):
    from repro_torch.launch.input_specs import cells
    assert list(cells(ARCHS)) == ref["cells"]


def test_mesh_coordinates_and_production_meshes():
    from repro_torch.launch.mesh import (make_mesh_for_devices,
                                         make_production_mesh)
    m = make_production_mesh()
    assert (m.axis_names, m.size) == (("data", "model"), 256)
    m2 = make_production_mesh(multi_pod=True)
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    assert [dict(make_mesh_for_devices(n).shape) for n in (1, 2, 4, 6, 32)] \
        == [{"data": 1, "model": 1}, {"data": 1, "model": 2},
            {"data": 1, "model": 4}, {"data": 3, "model": 2},
            {"data": 2, "model": 16}]
    mesh = Mesh((2, 2), ("data", "model"))
    assert [mesh.coord_of(r) for r in range(4)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    x = torch.arange(64.).reshape(8, 8)
    spec = (("data", "model"), None)
    blocks = [partition.shard(x, spec, mesh, mesh.coord_of(r))
              for r in range(4)]
    assert torch.equal(torch.cat(blocks), x)      # data-major, as jax cuts


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_local_build_equals_the_cut_global_model(arch, mode):
    """``partition.build_local`` draws each parameter whole and keeps one
    rank's block: at every coordinate of (2, 2) and (1, 4) its parameters
    equal the global model's cut by the rules, bit for bit, with the
    same axes (smoke configs, the same generator seed)."""
    cfg = get_config(arch, smoke=True)
    whole = dict(build_model(cfg, "cpu",
                             torch.Generator().manual_seed(3))
                 .named_parameters())
    for shape in ((2, 2), (1, 4)):
        mesh = Mesh(shape, ("data", "model"))
        layout = partition.param_layout(build_model(cfg, "meta"), mesh, mode)
        for rank in range(mesh.size):
            coord = mesh.coord_of(rank)
            local = partition.build_local(
                cfg, mesh, mode, "cpu", torch.Generator().manual_seed(3),
                coord=coord)
            got = dict(local.named_parameters())
            assert got.keys() == whole.keys()
            for name, p in got.items():
                want = partition.shard(whole[name].detach(),
                                       layout.specs[name], mesh, coord)
                assert p.shape == want.shape, (name, coord)
                assert torch.equal(p.detach(), want), (name, coord)
                assert p.axes == whole[name].axes
