"""The port's logical sharding rules and specs against the JAX package's, on the CPU.

Everything here is data (rule tables, partition specs, shapes), so every
comparison is exact: the port's :class:`~repro_torch.models.common.Spec`
equals ``tuple(PartitionSpec)`` entry for entry.  The port keeps one
parameter container a layer where the JAX package stacks each group's
layers, so a per-layer leaf's spec is the JAX leaf's without its leading
``layers`` entry (``layers`` maps to no grid axis under every rule set);
``lm.params_tree_axes`` (the training state's stacked layout) equals the
JAX ``lm.param_axes`` leaf for leaf.  The JAX rule functions read only a
mesh's ``axis_names`` and ``shape``, so they get a stand-in here: the
tests need no 256- or 512-device mesh.
"""

from types import SimpleNamespace

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import dryrun as jdry
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.training import optim as joptim
from repro_torch import configs as tconfigs
from repro_torch.core.distmatrix import make_context
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import LogicalGrid, make_production_mesh, mesh_chip_count
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.training import optim as toptim

ARCHS = list(tconfigs.ARCH_IDS)
GRIDS = {"single": (("data", "model"), (16, 16)), "multi": (("pod", "data", "model"), (2, 16, 16)),
         "2x2": (("data", "model"), (2, 2))}


def _jmesh(name):
    axes, sizes = GRIDS[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))


def _tgrid(name):
    return LogicalGrid(*GRIDS[name])


def _jpaths(tree) -> dict:
    """{path: tuple(spec)} of a JAX spec tree (dict keys and list indices)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): tuple(s)
            for path, s in flat}


def _tpaths(tree) -> dict:
    return {path: tuple(s) for path, s in tcm.axes_paths(tree)}


def _jaxes_paths(tree) -> dict:
    is_axes = lambda x: isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_axes)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): tuple(a)
            for path, a in flat}


# ---------------------------------------------------------------------------
# the rule tables
# ---------------------------------------------------------------------------


def test_default_and_multipod_rules_equal_jax():
    assert tcm.DEFAULT_RULES == jcm.DEFAULT_RULES
    assert tcm.multipod_rules() == jcm.multipod_rules()


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_rules_equal_jax(arch):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert tcfg.rules_override == jcfg.rules_override
    for base in ("default", "multipod"):
        t = dict(tcm.DEFAULT_RULES) if base == "default" else tcm.multipod_rules()
        j = dict(jcm.DEFAULT_RULES) if base == "default" else jcm.multipod_rules()
        assert tcm.arch_rules(tcfg, t) == jcm.arch_rules(jcfg, j)


@pytest.mark.parametrize("grid", ["single", "multi"])
def test_presets_and_rules_for_equal_jax(grid):
    tg, jg = _tgrid(grid), _jmesh(grid)
    assert set(tdry.RULE_PRESETS) == set(jdry.RULE_PRESETS)
    assert tdry.long_context_rules(tg) == jdry.long_context_rules(jg)
    assert tdry.fsdp_rules(tg) == jdry.fsdp_rules(jg)
    assert tdry.seqshard_rules(tg) == jdry.seqshard_rules(jg)
    for shape in jconfigs.ALL_SHAPES:
        tshape = tconfigs.SHAPES_BY_NAME[shape.name]
        for preset in jdry.RULE_PRESETS:
            assert tdry.rules_for(tg, tshape, preset) == jdry.rules_for(jg, shape, preset)


def test_production_mesh_and_chip_count():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert (mesh_chip_count(single), mesh_chip_count(multi)) == (256, 512)
    assert mesh_chip_count(make_context(["cpu"] * 6, 2)) == 6
    # the rules carry the grid's axis sizes as the JAX package's carry its mesh's
    for grid in ("single", "multi"):
        got = tcm.attach_axis_sizes(dict(tcm.DEFAULT_RULES), _tgrid(grid))
        want = jcm.attach_axis_sizes(dict(jcm.DEFAULT_RULES), _jmesh(grid))
        assert got == {k: v for k, v in want.items() if k != "_mesh"}


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [LogicalGrid(("data", "model"), (2, 2)),
                                  {"data": 2, "model": 2}], ids=["logical", "mapping"])
def test_sanitize_spec_drops_nondivisible(grid):
    """The JAX package's test_sanitize_spec_drops_nondivisible on a 2x2 grid."""
    assert tuple(tcm.sanitize_spec(tcm.Spec("model", "data"), (6, 4), grid)) == ("model", "data")
    assert tuple(tcm.sanitize_spec(tcm.Spec("model", "data"), (5, 4), grid)) == (None, "data")
    assert tuple(tcm.sanitize_spec(tcm.Spec(("data", "model"), None), (6, 4), grid)) == (None, None)


def test_sanitize_spec_matches_jax_over_shapes():
    specs = [P("data", "model"), P(("data", "model"), None), P(None, ("pod", "data")),
             P("model"), P(("pod", "data", "model"),), P()]
    for grid in ("multi", "2x2"):
        jg = _jmesh(grid)
        tg = _tgrid(grid)
        for spec in specs:
            if grid == "2x2" and "pod" in str(spec):
                continue
            for shape in [(32, 48), (6, 4), (512, 2), (5, 7), (16,), (1024, 3, 8)]:
                if len(tuple(spec)) > len(shape):
                    continue
                assert tuple(tcm.sanitize_spec(tcm.Spec(*spec), shape, tg)) == \
                    tuple(jcm.sanitize_spec(spec, shape, jg)), (grid, spec, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_cover_all_leaves(arch):
    """The JAX package's test_param_specs_cover_all_leaves, for every arch's
    SMOKE config: one spec a parameter (by the module's own names), none
    longer than its tensor's rank; likewise the stacked training tree."""
    spec = tlm.build_spec(tconfigs.get_smoke(arch))
    params = tlm.init_params(spec, device="meta")
    named = tcm.named_leaves(tlm.param_specs(spec, tcm.DEFAULT_RULES))
    tensors = dict(params.named_parameters())
    assert set(named) == set(tensors)
    for name, s in named.items():
        assert len(tuple(s)) <= tensors[name].ndim, name
    tree = tlm.params_tree(spec, params)
    specs = dict(tcm.axes_paths(tcm.tree_specs(tlm.params_tree_axes(spec), tcm.DEFAULT_RULES)))
    from repro_torch.tree import tree_paths

    leaves = dict(tree_paths(tree))
    assert set(specs) == set(leaves)
    for path, s in specs.items():
        assert len(tuple(s)) <= leaves[path].ndim, path


def _jax_block_index(jspec):
    """(group, block key) of every decoder block of the port's ``blocks`` list,
    in its order (shared-block positions have no parameters of their own)."""
    out = []
    for gi, g in enumerate(jspec.groups):
        for _ in range(g.count):
            out += [(gi, str(bi)) for bi, bt in enumerate(g.block_types) if bt != "shared_attn"]
    return out


@pytest.mark.parametrize("rules", ["default", "multipod", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_without_layers(arch, rules):
    """Every per-layer leaf's spec is its JAX counterpart's without ``layers``;
    the stacked training layout's specs equal the JAX package's exactly."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jspec, tspec = jlm.build_spec(jcfg), tlm.build_spec(tcfg)
    base = {"default": dict(jcm.DEFAULT_RULES), "multipod": jcm.multipod_rules(),
            "fsdp": jdry.fsdp_rules(_jmesh("single"))}[rules]
    jr, tr = jcm.arch_rules(jcfg, base), tcm.arch_rules(tcfg, dict(base))
    jp = _jpaths(jlm.param_specs(jspec, jr))
    assert _tpaths(tcm.tree_specs(tlm.params_tree_axes(tspec), tr)) == jp
    assert _jaxes_paths(jlm.param_axes(jspec)) == {
        p: tuple(a) for p, a in tcm.axes_paths(tlm.params_tree_axes(tspec))}
    tp = _tpaths(tlm.param_specs(tspec, tr))
    idx = _jax_block_index(jspec)
    enc = []
    for gi, g in enumerate(jspec.enc_groups):
        enc += [(gi, str(bi)) for _ in range(g.count) for bi in range(len(g.block_types))]
    seen = 0
    for path, s in tp.items():
        if path[0] in ("blocks", "enc_blocks"):
            gi, bk = (idx if path[0] == "blocks" else enc)[path[1]]
            jkey = ("groups" if path[0] == "blocks" else "enc_groups", gi, bk) + path[2:]
            assert jp[jkey][0] is None and s == jp[jkey][1:], (path, jkey)
        else:
            assert s == jp[path], path
        seen += 1
    assert seen == len(dict(tlm.init_params(tspec, device="meta").named_parameters()))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_equal_jax_without_layers(arch):
    """Each block's (and each shared-block invocation's) cache axes are the
    JAX group entry's without ``layers``; ``pos`` is unsharded in both."""
    jspec = jlm.build_spec(jconfigs.get_smoke(arch))
    tspec = tlm.build_spec(tconfigs.get_smoke(arch))
    jc, tc = jlm.cache_axes(jspec), tlm.cache_axes(tspec)
    assert tuple(jc["pos"]) == tuple(tc["pos"]) == ()
    want = []
    for gi, g in enumerate(jspec.groups):
        for _ in range(g.count):
            want += [{k: tuple(a[1:]) for k, a in jc["groups"][gi][str(bi)].items()}
                     for bi in range(len(g.block_types))]
    assert all(a[0] == "layers" for g in jc["groups"] for e in g.values() for a in e.values())
    assert [{k: tuple(a) for k, a in e.items()} for e in tc["layers"]] == want
    # and the caches the port makes have one entry a block, of the axes' ranks
    cache = tlm.init_cache(tspec, 2, 8, device="meta", enc_len=4)
    assert len(cache["layers"]) == len(tc["layers"])
    for entry, axes in zip(cache["layers"], tc["layers"]):
        assert set(entry) == set(axes)
        assert all(entry[k].ndim == len(axes[k]) for k in axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_state_specs_equal_jax(arch):
    """AdamW's and Adafactor's state specs over the stacked training tree equal
    the JAX package's leaf for leaf; per layer, AdamW's moments carry the
    layer's parameter specs."""
    jspec = jlm.build_spec(jconfigs.get_smoke(arch))
    tspec = tlm.build_spec(tconfigs.get_smoke(arch))
    rules = dict(jcm.DEFAULT_RULES)
    jps = jlm.param_specs(jspec, rules)
    tps = tcm.tree_specs(tlm.params_tree_axes(tspec), rules)
    assert _tpaths(toptim.adamw_state_specs(tps)) == _jpaths(joptim.adamw_state_specs(jps))
    pshape = jax.eval_shape(lambda k: jlm.init_params(jspec, k), jax.random.PRNGKey(0))
    tree = tlm.params_tree(tspec, tlm.init_params(tspec, device="meta"))
    assert _tpaths(toptim.adafactor_state_specs(tps, tree)) == \
        _jpaths(joptim.adafactor_state_specs(jps, pshape))
    per_layer = tlm.param_specs(tspec, rules)
    st = toptim.adamw_state_specs(per_layer)
    assert st["m"] is per_layer and st["v"] is per_layer and tuple(st["count"]) == ()
    # the specs pair with the states the optimizers make, leaf for leaf
    for name in ("adamw", "adafactor"):
        init, _ = toptim.make_optimizer(toptim.OptConfig(name=name))
        state = init(tree)
        specs = (toptim.adamw_state_specs(tps) if name == "adamw"
                 else toptim.adafactor_state_specs(tps, tree))
        tcm.map_axes(lambda s, x: None if len(tuple(s)) <= x.ndim else pytest.fail(name),
                     specs, state)


# ---------------------------------------------------------------------------
# shapes and cells
# ---------------------------------------------------------------------------


def _dtype_name(d) -> str:
    return str(d).removeprefix("torch.")


def test_shapes_equal_jax():
    assert [(s.name, s.kind, s.seq_len, s.global_batch) for s in tconfigs.ALL_SHAPES] == \
        [(s.name, s.kind, s.seq_len, s.global_batch) for s in jconfigs.ALL_SHAPES]
    assert set(tconfigs.SHAPES_BY_NAME) == set(jconfigs.SHAPES_BY_NAME)


def test_all_cells_and_supported_shapes_equal_jax():
    """32 runnable cells of the 40, as the JAX package's ``all_cells`` returns."""
    tcells = [(a, s.name) for a, s in tconfigs.all_cells()]
    assert tcells == [(a, s.name) for a, s in jconfigs.all_cells()]
    assert len(tcells) == 32
    for arch in ARCHS:
        tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        assert [s.name for s in tconfigs.supported_shapes(tcfg)] == \
            [s.name for s in jconfigs.supported_shapes(jcfg)]
        for shape in jconfigs.ALL_SHAPES:
            assert tconfigs.is_supported(tcfg, tconfigs.SHAPES_BY_NAME[shape.name]) == \
                jconfigs.is_supported(jcfg, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    """Names, shapes and dtypes of every cell's inputs; the port's are empty
    meta tensors."""
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for shape in jconfigs.supported_shapes(jcfg):
        j = jconfigs.input_specs(jcfg, shape)
        t = tconfigs.input_specs(tcfg, tconfigs.SHAPES_BY_NAME[shape.name])
        assert set(t) == set(j)
        for k in j:
            assert tuple(t[k].shape) == tuple(j[k].shape)
            assert _dtype_name(t[k].dtype) == str(j[k].dtype)
            assert t[k].device.type == "meta"
        small = tconfigs.input_specs(tcfg, tconfigs.SHAPES_BY_NAME[shape.name], batch=2,
                                     device="cpu")
        assert all(v.shape[0] == 2 and v.device.type == "cpu" for v in small.values())


def test_meta_init_params_matches_cpu_init():
    """The meta build makes the CPU build's tree: names, shapes, dtypes."""
    for arch in ARCHS:
        spec = tlm.build_spec(tconfigs.get_smoke(arch))
        meta = dict(tlm.init_params(spec, device="meta").named_parameters())
        cpu = dict(tlm.init_params(spec, seed=0, device="cpu").named_parameters())
        assert set(meta) == set(cpu)
        for k, v in cpu.items():
            assert (meta[k].shape, meta[k].dtype, meta[k].device.type) == (v.shape, v.dtype,
                                                                         "meta"), (arch, k)
