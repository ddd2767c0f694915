"""The port's streaming launcher against the reference's, on the CPU.

``python -m repro_torch.launch.stream --device cpu`` prints a
``state_digest=`` line over the final corpus, sketch table and pid table;
it must equal the reference launcher's ``state_digest`` of its session for
the same arguments (one shard and four, both routers, auto-rebalancing),
and a run stopped after a wave with ``--checkpoint-dir`` then resumed
with ``--resume`` must end at the uninterrupted run's digest.  The
journal flags raise before any work, naming their ROADMAP.md item.
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


@pytest.mark.parametrize("flag", ["--journal-dir", "--replay-journal"])
def test_journal_flags_raise_naming_item_14(tmp_path, capsys, flag):
    with pytest.raises(NotImplementedError, match="item 14"):
        stream.main(COHORT + ["--device", "cpu", flag, str(tmp_path / "j")])
    assert "state_digest" not in capsys.readouterr().out
