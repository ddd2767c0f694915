"""Tiered storage in the port (repro_torch.storage) against the reference.

Twin of tests/test_storage.py: codec round trips (empty, single-event,
duplicate-timestamp, unsorted and int32-extreme blocks, dictionary
escapes) with blocks byte-identical to the reference's encoding and
decodable by either package; blockstores written by one package read back
in the other; a corrupt block is refused; the tier contract; the
port's PatientStore walking device -> host -> disk exactly as the
reference's does; and the checkpoint state trees.
"""
import json

import numpy as np
import pytest

from repro.storage import blockstore as j_blockstore
from repro.storage import codec as j_codec
from repro.storage import state as j_state
from repro.stream.store import PatientStore as JStore
from repro_torch.storage import blockstore as blockstore_lib
from repro_torch.storage.blockstore import CompressedBlockStore
from repro_torch.storage.codec import (CodeDictionary, decode_block, decode_key,
                                       encode_block, encode_key, varint_decode,
                                       varint_encode, zigzag_decode, zigzag_encode)
from repro_torch.storage.state import pack_tree, unpack_tree
from repro_torch.storage.tiers import DiskTier, HostTier, ResidencyTier
from repro_torch.stream.store import PatientStore

I32 = np.iinfo(np.int32)


def _roundtrip(phenx, date, dictionary=None):
    """Port encode == reference encode, and each decodes the other's block."""
    blob = encode_block(phenx, date, dictionary)
    jdict = None if dictionary is None else j_codec.CodeDictionary(dictionary.codes)
    assert blob == j_codec.encode_block(phenx, date, jdict)
    for ph, dt in (decode_block(blob, dictionary), j_codec.decode_block(blob, jdict)):
        assert ph.dtype == np.int32 and dt.dtype == np.int32
        np.testing.assert_array_equal(ph, np.asarray(phenx, np.int32))
        np.testing.assert_array_equal(dt, np.asarray(date, np.int32))
    return blob


def test_codec_roundtrip_edge_blocks():
    empty = np.zeros(0, np.int32)
    _roundtrip(empty, empty)                            # empty history
    _roundtrip([7], [100])                              # single event
    _roundtrip([3, 3, 3], [50, 50, 50])                 # duplicate timestamps
    _roundtrip([1, 2, 3], [300, 200, 100])              # unsorted (neg deltas)
    _roundtrip([I32.min, I32.max, 0, -1],
               [I32.max, I32.min, 0, -1])               # int32 extremes


def test_codec_roundtrip_seeded_random():
    rng = np.random.default_rng(42)
    for _ in range(200):
        n = int(rng.integers(0, 40))
        if rng.random() < 0.5:   # clinical shape: small codes, sorted dates
            ph = rng.integers(0, 200, n).astype(np.int32)
            dt = np.sort(rng.integers(0, 2000, n)).astype(np.int32)
        else:                    # adversarial: full int32 range, unsorted
            ph = rng.integers(I32.min, I32.max, n, dtype=np.int64).astype(np.int32)
            dt = rng.integers(I32.min, I32.max, n, dtype=np.int64).astype(np.int32)
        d = (CodeDictionary.from_histories([ph[: n // 2]])
             if rng.random() < 0.5 else None)
        _roundtrip(ph, dt, d)


def test_codec_compresses_clinical_shape():
    rng = np.random.default_rng(0)
    raw = enc = 0
    d = CodeDictionary(list(range(200)))
    for _ in range(50):
        n = int(rng.integers(10, 60))
        ph = rng.integers(0, 200, n).astype(np.int32)
        dt = np.sort(rng.integers(0, 700, n)).astype(np.int32)
        enc += len(_roundtrip(ph, dt, d))
        raw += 8 * n
    assert raw / enc >= 3.0


def test_varint_and_zigzag_match_reference():
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        np.zeros(3, np.uint64),
        rng.integers(0, 1 << 35, 100, dtype=np.uint64),
        np.asarray([1, 127, 128, (1 << 35) - 1], np.uint64)])
    buf = varint_encode(vals)
    assert buf == j_codec.varint_encode(vals)
    np.testing.assert_array_equal(varint_decode(buf, len(vals)), vals)
    with pytest.raises(ValueError):
        varint_encode(np.asarray([1 << 35], np.uint64))
    with pytest.raises(ValueError):
        varint_decode(buf[:1], len(vals))   # truncated stream
    v = np.asarray([0, -1, 1, -2, 2, I32.min, I32.max], np.int64)
    np.testing.assert_array_equal(zigzag_encode(v), j_codec.zigzag_encode(v))
    np.testing.assert_array_equal(zigzag_decode(zigzag_encode(v)), v)


def test_dictionary_escape_side_stream():
    d = CodeDictionary([10, 20, 30])
    ph = np.asarray([10, 999, 20, -5, 30], np.int32)   # 999/-5 escape
    dt = np.asarray([1, 2, 3, 4, 5], np.int32)
    _roundtrip(ph, dt, d)
    assert CodeDictionary.from_json(d.to_json()) == d
    with pytest.raises(ValueError):
        decode_block(encode_block(ph, dt, d), None)  # dict required


def test_encode_key_typed_roundtrip():
    for key in [0, -3, 2**40, "p1", ("a", 7), (1, ("x", 2))]:
        assert encode_key(key) == j_codec.encode_key(key)
        assert decode_key(json.loads(json.dumps(encode_key(key)))) == key
    assert decode_key(encode_key(np.int32(5))) == 5
    with pytest.raises(TypeError):
        encode_key(True)
    with pytest.raises(TypeError):
        encode_key(3.5)


def _fill(bs, rng, keys):
    hist = {}
    for k in keys:
        n = int(rng.integers(0, 30))
        ph = rng.integers(0, 60, n).astype(np.int32)
        dt = np.sort(rng.integers(0, 900, n)).astype(np.int32)
        bs.put(k, ph, dt)
        hist[k] = (ph, dt)
    return hist


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_blockstore_crosses_packages(tmp_path, writer):
    """A blockstore written by one package reads back, byte-identical, in
    the other, and both packages write the same segment and index."""
    keys = [0, "p1", ("t", 5), 7, -2]
    d = [1, 2, 3, 40]
    roots = {}
    for name, mod, dct in (("port", blockstore_lib, CodeDictionary),
                           ("reference", j_blockstore, j_codec.CodeDictionary)):
        root = str(tmp_path / name)
        bs = mod.CompressedBlockStore(root, dictionary=dct(d))
        hist = _fill(bs, np.random.default_rng(8), keys)
        bs.discard(7)                     # a dead block in the segment
        bs.close()
        roots[name] = root
    for f in (blockstore_lib.DATA_NAME, blockstore_lib.INDEX_NAME):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "reference" / f).read_bytes()
    reader = (j_blockstore.CompressedBlockStore if writer == "port"
              else CompressedBlockStore)
    re = reader(roots[writer])
    assert re.keys() == [k for k in keys if k != 7]
    for k in re.keys():
        ph, dt = re.get(k)
        assert ph.tobytes() == hist[k][0].tobytes()
        assert dt.tobytes() == hist[k][1].tobytes()


def test_blockstore_persist_reopen(tmp_path):
    root = str(tmp_path / "bs")
    d = CodeDictionary([1, 2, 3])
    bs = CompressedBlockStore(root, dictionary=d)
    bs.put("a", [1, 2], [10, 20])
    bs.put(("t", 5), [3], [7])
    bs.close()
    re = CompressedBlockStore(root)          # dictionary loads from index
    assert re.dictionary == d
    ph, dt = re.get("a")
    assert ph.tolist() == [1, 2] and dt.tolist() == [10, 20]
    assert re.n_events(("t", 5)) == 1
    assert len(re) == 2 and set(re.keys()) == {"a", ("t", 5)}
    with pytest.raises(ValueError):
        CompressedBlockStore(root, dictionary=CodeDictionary([9]))


def test_blockstore_checksum_detects_corruption(tmp_path):
    root = str(tmp_path / "bs")
    bs = CompressedBlockStore(root)
    bs.put("k", list(range(20)), list(range(20)))
    bs.close()
    with open(str(tmp_path / "bs" / blockstore_lib.DATA_NAME), "r+b") as f:
        f.seek(4)
        f.write(b"\xff\xff")
    for store in (CompressedBlockStore, j_blockstore.CompressedBlockStore):
        with pytest.raises(IOError):
            store(root).get("k")


def test_blockstore_compaction_bounds_garbage(tmp_path, monkeypatch):
    monkeypatch.setattr(blockstore_lib, "COMPACT_FLOOR_BYTES", 64)
    bs = CompressedBlockStore(str(tmp_path / "bs"))
    keep = {}
    rng = np.random.default_rng(5)
    for i in range(60):
        ph = rng.integers(0, 50, 10).astype(np.int32)
        dt = np.sort(rng.integers(0, 300, 10)).astype(np.int32)
        bs.put(i, ph, dt)
        keep[i] = (ph, dt)
        if i >= 3:                    # churn: drop an old block each round
            bs.discard(i - 3)
            del keep[i - 3]
    assert bs.dead_bytes <= max(bs.bytes_held, 64)
    for k, (ph, dt) in keep.items():
        got = bs.get(k)
        assert got[0].tolist() == ph.tolist() and got[1].tolist() == dt.tolist()


@pytest.mark.parametrize("tier_cls", [HostTier, DiskTier])
def test_tier_contract(tier_cls, tmp_path):
    tier = (DiskTier(str(tmp_path / "d")) if tier_cls is DiskTier
            else HostTier())
    assert isinstance(tier, ResidencyTier)
    tier.hold("a", [1, 2], [5, 6])
    tier.hold("b", [3], [9])
    assert "a" in tier and len(tier) == 2
    assert tier.keys() == ["a", "b"]          # insertion order: LRU walk
    tier.hold("a", [1, 2], [5, 6])            # re-hold moves to the back
    assert tier.keys() == ["b", "a"]
    assert tier.event_counts() == {"b": 1, "a": 2}
    ph, dt = tier.peek("b")
    assert ph.tolist() == [3] and "b" in tier  # peek does not withdraw
    ph, dt = tier.restore("b")
    assert ph.tolist() == [3] and "b" not in tier
    assert tier.bytes_held() > 0
    tier.drop("a")
    assert len(tier) == 0


def _fill_stores(stores, rng, n=12):
    hist = {}
    for k in range(n):
        m = int(rng.integers(3, 15))
        ph = rng.integers(1, 50, m).astype(np.int32)
        dt = np.sort(rng.integers(0, 300, m)).astype(np.int32)
        hist[k] = (ph, dt)
        for store in stores:
            rows, _ = store.admit([k])
            store.append(rows, ph[None], dt[None], np.asarray([m], np.int32))
            store.evict_over_budget()
    return hist


def _tiers(store, keys):
    return {k: store.tier_of(k) for k in keys}


@pytest.mark.parametrize("disk_bytes", [None, 2000, 0])
def test_store_tier_walk_matches_reference(disk_bytes):
    """Same admits, appends and evictions: the same tier placement, pids,
    rows and histories as the reference store, and every tier restores
    exactly."""
    store = PatientStore(budget_bytes=4000, disk_bytes=disk_bytes, device="cpu")
    ref = JStore(budget_bytes=4000, disk_bytes=disk_bytes)
    hist = _fill_stores([store, ref], np.random.default_rng(0))
    assert _tiers(store, hist) == _tiers(ref, hist)
    assert (store.disk is None) == (disk_bytes is None)
    if disk_bytes is not None:
        assert "disk" in _tiers(store, hist).values()
    assert store.rows == ref.rows and store.pids == ref.pids
    for k, (ph, dt) in hist.items():
        got = store.history(k)
        assert got[0].tolist() == ph.tolist() and got[1].tolist() == dt.tolist()
    assert store.event_counts() == ref.event_counts()


def test_store_extract_from_disk_tier():
    store = PatientStore(budget_bytes=4000, disk_bytes=0, device="cpu")
    hist = _fill_stores([store], np.random.default_rng(2), n=6)
    key = next(k for k in hist if store.tier_of(k) == "disk")
    pid, ph, dt = store.extract(key)
    assert ph.tolist() == hist[key][0].tolist()
    assert store.tier_of(key) is None and key not in store.pids


@pytest.mark.parametrize("direction", ["reference->port", "port->reference"])
def test_store_state_dict_crosses_packages(direction):
    """A store's state_dict loads into the other package's store: planes,
    rows, free list and tier placement survive."""
    stores = {"port": PatientStore(budget_bytes=4000, disk_bytes=2000, device="cpu"),
              "reference": JStore(budget_bytes=4000, disk_bytes=2000)}
    src_name, dst_name = direction.split("->")
    src = stores[src_name]
    hist = _fill_stores([src], np.random.default_rng(3))
    state = src.state_dict()
    state = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in state.items()}
    packed, arrays = (pack_tree if src_name == "port" else j_state.pack_tree)(state)
    json.dumps(packed)                         # manifest-serializable
    dst = (PatientStore(budget_bytes=4000, disk_bytes=2000, device="cpu")
           if dst_name == "port" else JStore(budget_bytes=4000, disk_bytes=2000))
    dst.load_state_dict(unpack_tree(packed, arrays))
    assert np.asarray(src.phenx).tobytes() == np.asarray(dst.phenx).tobytes()
    assert np.asarray(src.nevents).tobytes() == np.asarray(dst.nevents).tobytes()
    assert src.rows == dst.rows and src.pids == dst.pids
    assert src._free == dst._free
    assert _tiers(src, hist) == _tiers(dst, hist)
    for k in hist:
        a, b = src.history(k), dst.history(k)
        assert a[0].tolist() == b[0].tolist() and a[1].tolist() == b[1].tolist()


def test_pack_tree_roundtrip():
    tree = {"a": np.arange(5), "b": [np.zeros((2, 3), np.int64), "x", None],
            "c": {"d": np.int32(7), "e": 1.5, "f": True}}
    packed, arrays = pack_tree(tree)
    assert packed == j_state.pack_tree(tree)[0]
    json.dumps(packed)
    out = unpack_tree(packed, arrays)
    np.testing.assert_array_equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"][0], tree["b"][0])
    assert out["b"][1:] == ["x", None]
    assert out["c"] == {"d": 7, "e": 1.5, "f": True}


def test_pack_tree_rejects_non_json_leaves():
    with pytest.raises(TypeError):
        pack_tree({"bad": object()})
    with pytest.raises(ValueError):
        pack_tree({"__ndarray__": 1})


def test_random_store_tier_walk_vs_dict_oracle():
    """Chaos: random admits/appends/evicts/extracts against a plain dict
    oracle and the reference store — whatever tier a history lands in,
    reads stay exact and the placement is the reference's."""
    rng = np.random.default_rng(11)
    store = PatientStore(budget_bytes=3000, disk_bytes=1000, device="cpu")
    ref = JStore(budget_bytes=3000, disk_bytes=1000)
    oracle: dict = {}
    next_key = 0
    for _ in range(150):
        r = rng.random()
        if r < 0.45 or not oracle:
            k, next_key = next_key, next_key + 1
            m = int(rng.integers(1, 10))
            ph = rng.integers(0, 99, m).astype(np.int32)
            dt = np.sort(rng.integers(0, 400, m)).astype(np.int32)
            for s in (store, ref):
                rows, _ = s.admit([k])
                s.append(rows, ph[None], dt[None], np.asarray([m], np.int32))
            oracle[k] = (ph, dt)
        elif r < 0.7:
            assert store.evict_over_budget() == ref.evict_over_budget()
        elif r < 0.85:
            k = list(oracle)[int(rng.integers(len(oracle)))]
            pid, ph, dt = store.extract(k)
            assert pid == ref.extract(k)[0]
            np.testing.assert_array_equal(ph, oracle.pop(k)[0])
        else:
            k = list(oracle)[int(rng.integers(len(oracle)))]
            ph, dt = store.history(k)
            np.testing.assert_array_equal(ph, oracle[k][0])
            np.testing.assert_array_equal(dt, oracle[k][1])
        assert _tiers(store, oracle) == _tiers(ref, oracle)
        assert store.phenx.shape == ref.phenx.shape
    assert store.event_counts() == {k: len(v[0]) for k, v in oracle.items()}
