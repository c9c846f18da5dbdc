"""PyTorch port, EDF storage and synthetic logs: files written by the JAX
package decode to identical columns in the port, the port's writer emits
the JAX package's bytes, streaming the DFG from disk equals the whole-log
DFG, and the port's generator gives the JAX generator's bits."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.storage import edf as jedf  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.storage import edf as tedf  # noqa: E402

jdfg = importlib.import_module("repro.core.dfg")
tdfg = importlib.import_module("repro_torch.core.dfg")
TABLES = {ACTIVITY: [f"act_{i}" for i in range(7)]}


def _cols(seed=0, n_cases=60, with_valid=False):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 9, n_cases)
    case = np.repeat(np.arange(n_cases, dtype=np.int32) * 2, lens)
    cols = {CASE: case,
            ACTIVITY: rng.integers(0, 7, case.size).astype(np.int32),
            TIMESTAMP: (np.arange(case.size) * 1.5).astype(np.float32),
            "attr0": rng.integers(-5, 1000, case.size).astype(np.int32)}
    valid = {}
    if with_valid:
        valid = {TIMESTAMP: rng.random(case.size) > 0.2,
                 "attr0": rng.random(case.size) > 0.5}
    return cols, valid


@pytest.mark.parametrize("version,codec,groups", [
    (1, "raw", None), (1, "zlib6", None), (2, "raw", 37), (2, "zlib1", 50),
    (3, "zlib1", 64), (3, "raw", None), (3, "zlib9", 1)])
@pytest.mark.parametrize("with_valid", [False, True])
def test_jax_files_decode_identically(tmp_path, version, codec, groups, with_valid):
    cols, valid = _cols(1, with_valid=with_valid)
    p = str(tmp_path / "log.edf")
    jedf.write(p, jcore.EventFrame.from_numpy(cols, valid), TABLES, codec=codec,
               row_group_rows=groups, version=version)
    got, tables = tedf.read(p, device="cpu")
    want, jtables = jedf.read(p)
    assert tables == jtables
    assert set(got.names) == set(want.names)
    for k in want.names:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert set(got.valid) == set(want.valid)
    for k in want.valid:
        np.testing.assert_array_equal(got.valid[k].numpy(), np.asarray(want.valid[k]))
    # per-group streaming decodes the same rows
    parts = list(tedf.read_streaming(p, columns=[CASE, ACTIVITY], device="cpu"))
    assert len(parts) == tedf.num_row_groups(p) == jedf.num_row_groups(p)
    np.testing.assert_array_equal(
        np.concatenate([f[CASE].numpy() for f, _ in parts]), cols[CASE])
    assert set(parts[0][0].names) == {CASE, ACTIVITY}
    g0, _ = tedf.read_group(p, 0, columns=[ACTIVITY], device="cpu")
    j0, _ = jedf.read_group(p, 0, columns=[ACTIVITY])
    np.testing.assert_array_equal(g0[ACTIVITY].numpy(), np.asarray(j0[ACTIVITY]))


@pytest.mark.parametrize("version,codec,groups", [
    (1, "raw", None), (1, "zlib1", None), (2, "zlib1", 40), (3, "zlib1", 33),
    (3, "raw", None), (3, "zlib6", 7)])
@pytest.mark.parametrize("with_valid", [False, True])
def test_port_writer_bytes_equal_jax(tmp_path, version, codec, groups, with_valid):
    cols, valid = _cols(2, with_valid=with_valid)
    pj, pt = str(tmp_path / "j.edf"), str(tmp_path / "t.edf")
    hj = jedf.write(pj, jcore.EventFrame.from_numpy(cols, valid), TABLES,
                    codec=codec, row_group_rows=groups, version=version)
    ht = tedf.write(pt, tcore.EventFrame.from_numpy(cols, valid, device="cpu"),
                    TABLES, codec=codec, row_group_rows=groups, version=version)
    assert hj == ht
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()


def test_port_files_read_in_jax_and_back(tmp_path):
    cols, valid = _cols(3, with_valid=True)
    cols[CASE] = cols[CASE].astype(np.int64)      # the port keeps int64 ids
    p = str(tmp_path / "t.edf")
    tedf.write(p, tcore.EventFrame.from_numpy(cols, valid, device="cpu"), TABLES,
               row_group_rows=25)
    jframe, _ = jedf.read(p)
    tframe, _ = tedf.read(p, device="cpu")
    assert tframe[CASE].dtype == torch.int64
    for k in cols:
        np.testing.assert_array_equal(np.asarray(jframe[k]), tframe[k].numpy())
    header, _ = tedf.read_header(p)
    assert header["version"] == 3 and len(header["groups"]) == tedf.num_row_groups(p)


def test_empty_frame_roundtrip(tmp_path):
    cols = {CASE: np.zeros(0, np.int64), ACTIVITY: np.zeros(0, np.int32)}
    p = str(tmp_path / "e.edf")
    tedf.write(p, tcore.EventFrame.from_numpy(cols, device="cpu"), TABLES)
    f, _ = tedf.read(p, device="cpu")
    assert f.nrows == 0 and set(f.names) == {CASE, ACTIVITY}


def test_not_an_edf_file(tmp_path):
    p = tmp_path / "x.edf"
    p.write_bytes(b"NOTEDF00" + b"\0" * 8)
    with pytest.raises(ValueError):
        tedf.read_header(str(p))


@pytest.mark.parametrize("group_rows", [1, 7, 128])
def test_streaming_dfg_from_disk_equals_whole_log(tmp_path, group_rows):
    frame, tables = tsyn.generate(num_cases=150, num_activities=9, seed=4,
                                  device="cpu")
    frame = frame.select([CASE, ACTIVITY])
    p = str(tmp_path / "s.edf")
    tedf.write(p, frame, tables, row_group_rows=group_rows)
    src = tcore.ChunkedEventFrame.from_edf(p, columns=[CASE, ACTIVITY], device="cpu")
    assert len(src) == -(-frame.nrows // group_rows)
    got = tcore.run_streaming(tdfg.dfg_kernel(9), src)
    whole = tdfg.dfg(frame, 9)
    jwhole = jdfg.dfg(jcore.EventFrame.from_numpy(frame.to_numpy()), 9)
    for nm in ("counts", "starts", "ends"):
        np.testing.assert_array_equal(getattr(got, nm).numpy(),
                                      getattr(whole, nm).numpy())
        np.testing.assert_array_equal(getattr(got, nm).numpy(),
                                      np.asarray(getattr(jwhole, nm)))
    assert src.tables[ACTIVITY] == tables[ACTIVITY]
    np.testing.assert_array_equal(src.materialize()[CASE].numpy(),
                                  frame[CASE].numpy())


@pytest.mark.parametrize("kwargs", [dict(num_cases=300, num_activities=26, seed=1),
                                    dict(num_cases=50, num_activities=5, seed=7,
                                         extra_numeric_attrs=0,
                                         mean_len_target=3.0)])
def test_synthetic_matches_jax_bits(kwargs):
    jf, jt = jsyn.generate(**kwargs)
    tf, tt = tsyn.generate(**kwargs, device="cpu")
    assert jt == tt
    assert set(tf.names) == set(jf.names)
    assert tf[CASE].dtype == torch.int64       # JAX narrows ids to int32
    for k in jf.names:
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]), err_msg=k)
    assert tsyn.paper_table6_config(1) == jsyn.paper_table6_config(1)


def test_from_synthetic_stream_matches_jax():
    jsrc = jcore.ChunkedEventFrame.from_synthetic(90, 40, num_activities=6, seed=3)
    tsrc = tcore.ChunkedEventFrame.from_synthetic(90, 40, num_activities=6, seed=3,
                                                  device="cpu")
    assert len(tsrc) == len(jsrc) == 3
    for tc, jc in zip(tsrc, jsrc):
        for k in jc.names:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    got = tcore.run_streaming(tdfg.dfg_kernel(6), tsrc)
    want = jcore.run_streaming(jdfg.dfg_kernel(6), jsrc)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))


@pytest.mark.parametrize("version,codec,groups", [
    (1, "zlib1", None), (2, "raw", 37), (2, "zlib6", 50), (3, "zlib1", 64),
    (3, "raw", 1_000)])
@pytest.mark.parametrize("with_valid", [False, True])
def test_reader_metadata_equals_jax(tmp_path, version, codec, groups, with_valid):
    """``EDFReader`` over a file the JAX package wrote: zone maps, segment
    counts, tail halos and sketch bands (straight from a v3 header,
    synthesized for v1/v2), content signatures, per-group byte extents,
    the file's size accounting and its staleness signature all equal the
    JAX reader's; each group decodes to the JAX reader's columns."""
    cols, valid = _cols(5, with_valid=with_valid)
    p = str(tmp_path / "m.edf")
    jedf.write(p, jcore.EventFrame.from_numpy(cols, valid), TABLES, codec=codec,
               row_group_rows=groups, version=version)
    tr, jr = tedf.EDFReader(p), jedf.EDFReader(p)
    assert tr.num_groups == jr.num_groups
    assert (tr.version, tr.nrows, tr.tables, tr.column_names) == \
        (jr.version, jr.nrows, jr.tables, jr.column_names)
    for g in range(jr.num_groups):
        assert tr.group_meta(g) == jr.group_meta(g)
        tsk, jsk = tr.group_sketch(g), jr.group_sketch(g)
        assert set(tsk) == set(jsk)
        for k in jsk:
            assert tsk[k].dtype == jsk[k].dtype
            np.testing.assert_array_equal(tsk[k], jsk[k])
        assert tr.group_signature(g) == jr.group_signature(g)
        assert tr.group_nrows(g) == jr.group_nrows(g)
        for proj in (None, [CASE], [ACTIVITY, TIMESTAMP]):
            assert tr.group_nbytes(g, proj) == jr.group_nbytes(g, proj)
            got = tr.read_group(g, proj, device="cpu")
            want = jr.read_group(g, proj)
            assert set(got.names) == set(want.names)
            for k in want.names:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            for k in want.valid:
                np.testing.assert_array_equal(got.valid[k].numpy(),
                                              np.asarray(want.valid[k]))
    assert tedf.file_sizes(p) == jedf.file_sizes(p)
    assert tedf.file_sig(p) == jedf.file_sig(p)
    assert tedf.header_tag(p) == jedf.header_tag(p)
    tr.close()
    assert tr.closed
    tr.read_group(0, device="cpu")           # reopens transparently
    assert tedf.pooled_reader(p) is tedf.reader_pool().get(p)
