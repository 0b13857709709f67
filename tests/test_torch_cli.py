"""The port's CLI against the JAX package's, on the CPU.

``wfa_tpu_torch.cli.main([..., "--device", "cpu"])`` and
``wfa_tpu.cli.main([...])`` run on the same arguments and must write the
same standard output, byte for byte, and the same lines on standard
error but the timing line."""

import io
import os
import sys

import pytest
import torch

from wfa_tpu.datagen import generate_pairs, write_pair_file

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQS = os.path.join(REPO, "tests", "data", "seqs.txt")
POS = ["AGCTAGTGTCAATGGCTACTTTTCAGGTCCT",
       "AACTAAGTGTCGGTGGCTACTATATATCAGGTCCT"]
FRONT = ["Bioinformatics helps Biology",
         "We learn bioinformatics to help biologists"]


def run(mod, args, capsys):
    """(return code, stdout, stderr lines but the timing line) of
    ``mod.main(args)``."""
    capsys.readouterr()
    buf, old = io.StringIO(), sys.stdout
    sys.stdout = buf  # the CLI binds sys.stdout when main starts
    try:
        rc = mod.main(list(args))
    finally:
        sys.stdout = old
    err = [line for line in capsys.readouterr().err.splitlines()
           if not line.startswith("aligned ")]
    return rc, buf.getvalue(), err


def both(args, capsys):
    import wfa_tpu.cli as jcli

    import wfa_tpu_torch.cli as tcli

    want = run(jcli, args, capsys)
    got = run(tcli, [*args, "--device", "cpu"], capsys)
    assert got == want
    return got


@pytest.fixture(scope="module")
def pair_file(tmp_path_factory):
    """40 pairs of l=60 (ragged over a mesh of 4) and a bad pair."""
    path = tmp_path_factory.mktemp("cli") / "pairs.txt"
    write_pair_file(str(path), generate_pairs(40, 60, 0.1, seed=5))
    with open(path, "ab") as fh:
        fh.write(b">\n<ACGT\n>A\n<G\n")
    return str(path)


@pytest.mark.parametrize("args,rc", [
    (["-i", SEQS], 0), (POS, 0), (["-g", "-i", SEQS], 0),
    (["-t", "-i", SEQS], 0), (["-g", "-t", *FRONT], 0),
    (["-N", "-i", SEQS], 0), (["-a", "-i", SEQS], 0),
    (["-a", "-g", *FRONT], 0), (["--no-device", "-i", SEQS], 0),
    (["ONLYONESEQ"], 1), (["-i", "no/such/file.txt"], 1),
], ids=["file", "positional", "semi", "trim", "semi_trim", "no_output",
        "no_adaptive", "semi_no_adaptive", "no_device", "missing_args",
        "missing_file"])
def test_cli_matches_jax(args, rc, capsys):
    got = both(args, capsys)
    assert got[0] == rc
    assert ("align-score" in got[1]) == (rc == 0 and "-N" not in args)


@pytest.mark.parametrize("trim", [False, True], ids=["full", "trim"])
def test_cli_bad_pairs_match_jax(pair_file, trim, capsys):
    """An empty sequence and, under -t, a pair with no M region are
    reported on standard error, and the run goes on."""
    args = ["-i", pair_file] + (["-t"] if trim else [])
    rc, out, err = both(args, capsys)
    assert rc == 0 and out.count("align-score") == 40 + (not trim)
    assert "pair 41: wfa: invalid empty sequence" in err
    assert ("pair 42: no aligned (M) region to trim to" in err) == trim


def test_cli_devices_match_jax(pair_file, capsys):
    """--devices 4 (4 virtual shards of the CPU in the port, 4 of the
    virtual XLA devices in JAX) against JAX's --devices 4, and against
    the port's --devices 1."""
    import wfa_tpu_torch.cli as tcli

    _, out, err = both(["--devices", "4", "-i", pair_file], capsys)
    one = run(tcli, ["--devices", "1", "-i", pair_file, "--device", "cpu"],
              capsys)
    assert one == (0, out, err)


def test_cli_resume_matches_jax(tmp_path, pair_file, capsys):
    """--resume skips the pairs a progress file records and writes the new
    count, as the JAX package's CLI does."""
    import wfa_tpu.cli as jcli

    import wfa_tpu_torch.cli as tcli

    outs = []
    for mod, extra in ((jcli, []), (tcli, ["--device", "cpu"])):
        state = tmp_path / f"progress_{mod.__name__}"
        state.write_text("37")
        outs.append(run(mod, ["-i", pair_file, "--resume", str(state),
                              *extra], capsys))
        assert state.read_text() == "42"
    assert outs[0] == outs[1]
    assert outs[0][2][0] == "resuming after 37 completed pairs"
    assert outs[0][1].count("align-score") == 4


def test_cli_runs_on_the_card_by_default(monkeypatch):
    """Without --device the CLI runs on the card: with none here, it
    raises rather than running on the CPU, and so does a mesh of more
    cards than there are."""
    import wfa_tpu_torch.cli as tcli

    assert tcli.build_parser().parse_args(["-i", SEQS]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default runs")
    for extra in ([], ["--devices", "2"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(["-i", SEQS, *extra])


def test_cli_distributed_needs_a_group(monkeypatch):
    """--distributed with a process count but no rendezvous address
    raises; it does not run as one process."""
    import wfa_tpu_torch.cli as tcli

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError):
        tcli.main(["--distributed", "-i", SEQS, "--device", "cpu"])
