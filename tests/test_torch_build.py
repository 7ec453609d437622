"""The build key of ``ops/build.py`` covers the ``csrc/`` headers a source
includes, so a header edit rebuilds every library that includes it (and
only those).  Runs on the CPU: nothing is compiled."""

import shutil

import pytest

from pysph_tpu_torch.ops import build
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / 'csrc'
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, 'CSRC', copy)
    return copy


def test_sources_follow_the_includes(csrc):
    for name in ('wcsph_pair', 'dense_pair', 'pair_stub'):
        assert [p.name for p in build.sources(name)] == [
            name + '.cu', 'wcsph_terms.cuh', 'cell_pack.cuh', 'cell_walk.cuh',
            'shapes.cuh']
    assert [p.name for p in build.sources('fused_pair')] == [
        'fused_pair.cu', 'cell_pack.cuh', 'cell_walk.cuh']
    assert [p.name for p in build.sources('gtvf_pair')] == [
        'gtvf_pair.cu', 'cell_pack.cuh', 'cell_walk.cuh', 'shapes.cuh']
    assert [p.name for p in build.sources('cell_pack')] == [
        'cell_pack.cu', 'cell_pack.cuh']
    for name in ('micro_launch', 'micro_engine', 'bin_cells'):
        assert [p.name for p in build.sources(name)] == [name + '.cu']


def test_header_edit_changes_the_key(csrc):
    names = ('wcsph_pair', 'dense_pair', 'pair_stub', 'fused_pair',
             'gtvf_pair', 'micro_engine', 'cell_pack', 'bin_cells')
    before = {n: build.build_key(n) for n in names}
    assert before == {n: build.build_key(n) for n in names}
    header = csrc / 'wcsph_terms.cuh'
    header.write_text(header.read_text() + '\n// edited\n')
    after = {n: build.build_key(n) for n in names}
    assert after['wcsph_pair'] != before['wcsph_pair']
    assert after['dense_pair'] != before['dense_pair']
    assert after['pair_stub'] != before['pair_stub']
    assert after['micro_engine'] == before['micro_engine']
    assert after['fused_pair'] == before['fused_pair']
    assert after['gtvf_pair'] == before['gtvf_pair']
    assert after['cell_pack'] == before['cell_pack']
    assert after['bin_cells'] == before['bin_cells']
    # the pack's header: the pack and the five walks that launch it
    pack = csrc / 'cell_pack.cuh'
    pack.write_text(pack.read_text() + '\n// edited\n')
    edited = {n: build.build_key(n) for n in names}
    assert {n for n in names if edited[n] != after[n]} == {
        'wcsph_pair', 'dense_pair', 'pair_stub', 'fused_pair', 'gtvf_pair',
        'cell_pack'}
    # the walk's header: the five walks
    walk = csrc / 'cell_walk.cuh'
    walk.write_text(walk.read_text() + '\n// edited\n')
    walked = {n: build.build_key(n) for n in names}
    assert {n for n in names if walked[n] != edited[n]} == {
        'wcsph_pair', 'dense_pair', 'pair_stub', 'fused_pair', 'gtvf_pair'}
    # the shape functions' header: the four walks that compute WIJ
    shapes = csrc / 'shapes.cuh'
    shapes.write_text(shapes.read_text() + '\n// edited\n')
    shaped = {n: build.build_key(n) for n in names}
    assert {n for n in names if shaped[n] != walked[n]} == {
        'wcsph_pair', 'dense_pair', 'pair_stub', 'gtvf_pair'}
    # a nested include counts too
    (csrc / 'extra.cuh').write_text('// v1\n')
    header.write_text('#include "extra.cuh"\n' + header.read_text())
    nested = build.build_key('dense_pair')
    (csrc / 'extra.cuh').write_text('// v2\n')
    assert build.build_key('dense_pair') != nested


def test_missing_header_is_an_error(csrc):
    src = csrc / 'fused_pair.cu'
    src.write_text('#include "nowhere.cuh"\n' + src.read_text())
    with pytest.raises(FileNotFoundError, match='nowhere.cuh'):
        build.build_key('fused_pair')


def test_each_later_kind_is_a_library_of_its_own(csrc, monkeypatch):
    """Kinds 0-3 launch from the default library; each later kind from a
    library built with -DPAIR_KIND=<kind>, which the kind's launch asks
    for and no other."""
    assert build.kind_flags(0) == build.kind_flags(3) == ()
    assert build.kind_flags(4) == ('-DPAIR_KIND=4',)
    keys = {build.build_key('wcsph_pair', build.kind_flags(k))
            for k in range(build.KINDS)}
    assert len(keys) == 5
    asked = []

    def load(name, args_type, extra=()):
        asked.append((name, extra))
        raise RuntimeError('stop')

    monkeypatch.setattr(build, 'load_library', load)
    from pysph_tpu_torch.ops import wcsph_pair as wp
    for kind in (0, 3, 6):
        args = wp.WcsphArgs()
        args.kernel_kind = kind
        with pytest.raises(RuntimeError, match='stop'):
            build.launch('wcsph_pair', args, None)
    assert asked == [('wcsph_pair', ()), ('wcsph_pair', ()),
                     ('wcsph_pair', ('-DPAIR_KIND=6',))]
