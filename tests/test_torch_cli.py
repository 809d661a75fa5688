"""The port's CLI: ``tests/test_cli.py``'s round-trips with ``--device cpu``
(the device probe path on the kernels' plain versions), and datasets loaded
by one package's CLI searched through the other's."""

import json

import pytest
import torch

torch.set_num_threads(1)

from bloomsearch_tpu import cli as jcli  # noqa: E402
from bloomsearch_tpu_torch import cli  # noqa: E402

CPU = ["--device", "cpu"]


def rows_of(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line]


def test_load_search_merge_roundtrip(tmp_path, capsys):
    jsonl = tmp_path / "logs.jsonl"
    with open(jsonl, "w") as fh:
        for i in range(50):
            fh.write(json.dumps({"n": i, "svc": "auth", "msg": f"tok{i} common"}) + "\n")
        fh.write("\n")  # blank lines skipped
        fh.write(json.dumps({"n": 50, "svc": "pay", "msg": "connection 9 timeout"}) + "\n")

    data_dir = str(tmp_path / "data")
    cli.main(["load", "--dir", data_dir, *CPU, str(jsonl)])
    assert "loaded 51 rows" in capsys.readouterr().out

    cli.main(["search", "--dir", data_dir, *CPU, "--token", "tok7"])
    assert rows_of(capsys) == [{"n": 7, "svc": "auth", "msg": "tok7 common"}]

    cli.main([
        "search", "--dir", data_dir, *CPU,
        "--field-token", "svc:pay", "--regex", r"msg=connection \d+ timeout",
    ])
    rows = rows_of(capsys)
    assert len(rows) == 1 and rows[0]["n"] == 50

    cli.main(["search", "--dir", data_dir, *CPU, "--token", "common", "--limit", "5"])
    assert len(rows_of(capsys)) == 5

    cli.main(["merge", "--dir", data_dir, *CPU])
    assert "merged" in capsys.readouterr().out


def test_object_dir_backend(tmp_path, capsys):
    jsonl = tmp_path / "x.jsonl"
    jsonl.write_text(json.dumps({"m": "needle row"}) + "\n")
    bucket = str(tmp_path / "bucket")
    cli.main(["load", "--object-dir", bucket, *CPU, str(jsonl)])
    capsys.readouterr()  # drain the load summary
    cli.main(["search", "--object-dir", bucket, *CPU, "--token", "needle"])
    assert rows_of(capsys) == [{"m": "needle row"}]


def test_bad_specs_rejected(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["search", "--dir", str(tmp_path), *CPU, "--field-token", "nocolon"])
    with pytest.raises(SystemExit):
        cli.main(["search", "--dir", str(tmp_path), *CPU, "--regex", "noequals"])


@pytest.mark.parametrize("loader", ["jax", "port"])
def test_a_dataset_loaded_by_one_package_searches_alike_in_the_other(tmp_path, capsys, loader):
    jsonl = tmp_path / "logs.jsonl"
    with open(jsonl, "w") as fh:
        for i in range(300):
            fh.write(json.dumps({"n": i, "svc": ["auth", "pay", "sched"][i % 3],
                                 "msg": f"req{i} status {i % 7} ok"}) + "\n")
    data_dir = str(tmp_path / "data")
    load = jcli.main if loader == "jax" else cli.main
    load(["load", "--dir", data_dir, "--probe-backend", "host",
          *(CPU if loader == "port" else []), str(jsonl)])
    capsys.readouterr()
    searches = [
        ["--token", "req42"],
        ["--field-token", "svc:pay", "--regex", r"msg=status [34] ok"],
        ["--field", "svc", "--token", "ok"],
    ]
    for search in searches:
        jcli.main(["search", "--dir", data_dir, "--probe-backend", "host", *search])
        want = sorted(map(json.dumps, rows_of(capsys)))
        cli.main(["search", "--dir", data_dir, *CPU, *search])
        got = sorted(map(json.dumps, rows_of(capsys)))
        assert got == want and want, search
