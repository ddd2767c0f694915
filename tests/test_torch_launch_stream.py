"""The port's streaming launcher against the reference's, on the CPU.

``python -m repro_torch.launch.stream --device cpu`` prints a
``state_digest=`` line over the final corpus, sketch table and pid table;
it must equal the reference launcher's ``state_digest`` of its session for
the same arguments (one shard and four, both routers, auto-rebalancing),
and a run stopped after a wave with ``--checkpoint-dir`` then resumed
with ``--resume`` must end at the uninterrupted run's digest.  A run with
``--journal-dir`` verifies its journal, and ``--replay-journal`` on it
prints that run's digest, which is the reference launcher's.
"""
import re

import pytest

from repro.launch import stream as j_stream
from repro_torch.launch import stream

COHORT = ["--patients", "36", "--avg-events", "12", "--waves", "4",
          "--tick-patients", "4"]


def digest_of(out: str) -> str:
    found = re.findall(r"^state_digest=([0-9a-f]{64})$", out, re.M)
    assert len(found) == 1, out
    return found[0]


@pytest.mark.parametrize("flags", [
    [],
    ["--shards", "4", "--router", "hash", "--rebalance-every", "4"],
    ["--shards", "4", "--router", "balance"],
    ["--shards", "3", "--router", "hash", "--rebalance-every", "2",
     "--imbalance-threshold", "1.05", "--min-gain", "0", "--budget-mb", "1",
     "--disk-bytes", "20000"],
])
def test_digest_equals_reference(capsys, flags):
    argv = COHORT + flags
    session = stream.main(argv + ["--device", "cpu"])
    got = digest_of(capsys.readouterr().out)
    ref = j_stream.main(argv)
    capsys.readouterr()
    assert got == stream.state_digest(session.service) == \
        j_stream.state_digest(ref.service)
    if "--rebalance-every" in flags and "1.05" in flags:
        assert session.service.migrations == ref.service.migrations != []


@pytest.mark.parametrize("shards", ["1", "4"])
def test_stop_and_resume_gives_the_uninterrupted_digest(tmp_path, capsys, shards):
    argv = COHORT + ["--device", "cpu", "--shards", shards, "--router", "hash"]
    if shards != "1":
        argv += ["--rebalance-every", "4"]
    stream.main(argv)
    whole = digest_of(capsys.readouterr().out)
    ck = ["--checkpoint-dir", str(tmp_path)]
    stream.main(argv + ck + ["--stop-after-wave", "1"])
    out = capsys.readouterr().out
    assert "stopping after wave 1" in out and digest_of(out) != whole
    stream.main(argv + ck + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "at wave 2" in out
    assert digest_of(out) == whole


@pytest.mark.parametrize("shards", ["1", "4"])
def test_journal_flags_give_the_reference_digest(tmp_path, capsys, shards):
    """``--journal-dir`` journals and verifies the run; ``--replay-journal``
    on that journal prints the same ``state_digest=``, which equals the
    reference launcher's for the same arguments (and the reference's
    replay of the port's journal)."""
    argv = COHORT + ["--shards", shards, "--router", "hash"]
    if shards != "1":
        argv += ["--rebalance-every", "4"]
    jdir = str(tmp_path / "j")
    stream.main(argv + ["--device", "cpu", "--journal-dir", jdir,
                        "--journal-commit-every", "4"])
    out = capsys.readouterr().out
    assert re.search(r"^journal .*: \d+ entries, \d+ commitments -> "
                     r"VerifyResult\(ok: ", out, re.M), out
    journaled = digest_of(out)
    session = stream.main(["--device", "cpu", "--replay-journal", jdir])
    out = capsys.readouterr().out
    assert "replayed" in out and digest_of(out) == journaled
    assert session.device.type == "cpu"
    ref = j_stream.main(argv)
    capsys.readouterr()
    assert journaled == j_stream.state_digest(ref.service)
    ref = j_stream.main(["--replay-journal", jdir])
    capsys.readouterr()
    assert journaled == j_stream.state_digest(ref.service)
