"""CLI entry points: train (reference flags), convert, predict."""

import numpy as np

from cuda_recommender_tpu.cli import convert as cli_convert
from cuda_recommender_tpu.cli import predict as cli_predict
from cuda_recommender_tpu.cli import train as cli_train


def test_train_cli_synthetic_golden(capsys):
    rc = cli_train.main(["--dataset", "synthetic:m=200,n=80,nnz=4000",
                         "-k", "4", "-t", "2", "-l", "0.1", "-OMP"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Picked Version: CCD!" in out
    assert "Check... PASS!" in out


def test_train_cli_hybrid_panel_widths_auto(capsys):
    """--panel-widths exposes the data-driven auto stair (and explicit width
    lists) on the hybrid backend through the user-facing CLI."""
    rc = cli_train.main(["--dataset", "synthetic:m=300,n=120,nnz=6000",
                         "--backend", "hybrid", "--hybrid-cells", "9000",
                         "--panel-widths", "auto",
                         "-k", "4", "-t", "2", "-l", "0.1"])
    assert rc == 0
    assert "RMSE" in capsys.readouterr().out
    rc = cli_train.main(["--dataset", "synthetic:m=300,n=120,nnz=6000",
                         "--backend", "hybrid", "--hybrid-cells", "9000",
                         "--panel-widths", "64,16",
                         "-k", "4", "-t", "2", "-l", "0.1"])
    assert rc == 0


def test_train_cli_als_save_model(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = cli_train.main(["--dataset", "synthetic:m=150,n=60,nnz=3000",
                         "-ALS", "-k", "4", "-t", "2",
                         "--save-model", str(tmp_path / "model")])
    assert rc == 0
    assert "Picked Version: ALS!" in capsys.readouterr().out
    assert (tmp_path / "model").exists()


def test_train_cli_als_r5_knobs(capsys):
    """The round-5 ALS knobs (degree-adaptive bucket floor, group budget,
    gather-cliff tiling threshold) are reachable from the user-facing CLI,
    including the tiling-disabled (pre-r5) configuration."""
    rc = cli_train.main(["--dataset", "synthetic:m=150,n=60,nnz=3000",
                         "-ALS", "-k", "4", "-t", "2",
                         "--als-min-width", "32",
                         "--als-group-mb", "512",
                         "--als-gather-tile-mb", "0"])
    assert rc == 0
    assert "Picked Version: ALS!" in capsys.readouterr().out
    rc = cli_train.main(["--dataset", "synthetic:m=150,n=60,nnz=3000",
                         "-ALS", "-k", "4", "-t", "1",
                         "--als-min-width", "auto",
                         "--als-gather-tile-mb", "0.0001"])
    assert rc == 0


def test_convert_then_train_then_predict(tmp_path, capsys):
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(3000):
        u = int(rng.integers(1, 120))
        i = int(rng.integers(1, 50))
        lines.append(f"{u} {i} {rng.integers(1, 6)}")
    src = tmp_path / "ratings.txt"
    src.write_text("\n".join(dict.fromkeys(lines)) + "\n")
    ds = str(tmp_path / "ds")

    assert cli_convert.main([str(src), ds, "--test-fraction", "0.2"]) == 0
    model = str(tmp_path / "model")
    assert cli_train.main([ds, "-k", "4", "-t", "2",
                           "--save-model", model]) == 0

    test_txt = tmp_path / "t.txt"
    test_txt.write_text("1 1 3.0\n5 2 4.0\n")
    rc = cli_predict.main(["score", model, str(test_txt),
                           "-o", str(tmp_path / "out")])
    assert rc == 0
    assert len(np.loadtxt(tmp_path / "out", ndmin=1)) == 2

    rc = cli_predict.main(["topk", model, "0,1", "-k", "5", "--chunk", "16"])
    assert rc == 0
    assert "user 0:" in capsys.readouterr().out


def test_train_cli_mesh(capsys):
    rc = cli_train.main(["--dataset", "synthetic:m=160,n=64,nnz=3000",
                         "-k", "4", "-t", "2", "--backend", "ell",
                         "--mesh", "8"])
    assert rc == 0
    assert "iteration num 2" in capsys.readouterr().out


def test_bench_cli_sweep(tmp_path, capsys):
    from cuda_recommender_tpu.cli import bench as cli_bench
    out = tmp_path / "sweep.jsonl"
    rc = cli_bench.main(["--dataset", "synthetic:m=120,n=50,nnz=2000",
                         "--ks", "3", "--inners", "1", "--solvers", "ccd,als",
                         "--iters", "2", "-o", str(out)])
    assert rc == 0
    import json
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert {r["solver"] for r in recs} == {"ccd", "als"}
    assert all(r["final_rmse"] is not None for r in recs)
    # backend labels must reflect what actually ran
    assert all(r["backend"] in ("dense", "ell") for r in recs)


def test_bench_cli_backend_ref(capsys):
    from cuda_recommender_tpu.cli import bench as cli_bench
    rc = cli_bench.main(["--dataset", "synthetic:m=80,n=40,nnz=1200",
                         "--ks", "3", "--solvers", "ccd", "--iters", "1",
                         "--backend", "ref"])
    assert rc == 0
    import json
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["backend"] == "ref"


def test_bench_serve_cli(capsys):
    from cuda_recommender_tpu.cli import bench_serve
    rc = bench_serve.main(["--dataset", "synthetic:m=300,n=120,nnz=6000",
                           "--queries", "256", "--batch", "128",
                           "--chunk", "128", "--topk", "5"])
    assert rc == 0
    import json
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] > 0 and rec["unit"] == "queries/s/chip"


def test_bench_cli_hybrid_knobs(tmp_path):
    """The sweep grid can exercise the flagship hybrid config (budget,
    panel widths incl. 'auto', storage dtypes) and records the knobs per
    row."""
    from cuda_recommender_tpu.cli import bench as cli_bench
    out = tmp_path / "sweep.jsonl"
    rc = cli_bench.main(["--dataset", "synthetic:m=200,n=80,nnz=4000",
                         "--ks", "3", "--solvers", "ccd", "--iters", "2",
                         "--backend", "hybrid", "--budget", "6000",
                         "--panel-widths", "auto",
                         "--residual-dtype", "bfloat16",
                         "--mask-dtype", "nan", "-o", str(out)])
    assert rc == 0
    import json
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert all(r["backend"] == "hybrid" for r in recs)
    assert all(r["cfg"]["hybrid_panel_widths"] == "auto" for r in recs)
    assert all(r["cfg"]["hybrid_dense_cells"] == 6000 for r in recs)
    assert all(r["final_rmse"] is not None for r in recs)
