"""CLI driver (python -m scheme_raytrace) — render from the shell with
progressive stats, resume, and PPM output (SURVEY §5.5/§5.6; VERDICT r1
items 5/9)."""

import os

import numpy as np

from scheme_raytrace.__main__ import main


def test_cli_scenes_lists(capsys):
    main(["scenes"])
    out = capsys.readouterr().out
    assert "cornell" in out and "three_spheres" in out


def test_cli_render_writes_ppm_and_stats(tmp_path, capsys):
    out = tmp_path / "img.ppm"
    st = tmp_path / "state.npz"
    main(["render", "--scene", "three_spheres", "--nx", "12", "--ny", "12",
          "--spp", "4", "--max-depth", "3", "--chunk", "2",
          "--pool-rays", "256",
          "--out", str(out), "--save-state", str(st)])
    text = capsys.readouterr().out
    assert "Mrays/s" in text and "occupancy" in text
    assert out.exists() and st.exists()
    with open(out) as f:
        assert f.readline().strip() == "P3"
        assert f.readline().split() == ["12", "12"]


def test_cli_resume_matches_one_shot(tmp_path):
    o1 = tmp_path / "a.ppm"
    o2 = tmp_path / "b.ppm"
    st = tmp_path / "st.npz"
    common = ["--scene", "three_spheres", "--nx", "8", "--ny", "8",
              "--max-depth", "3", "--chunk", "2", "--pool-rays", "128"]
    main(["render", *common, "--spp", "2", "--out", str(o1),
          "--save-state", str(st)])
    main(["render", *common, "--spp", "4", "--out", str(o1),
          "--resume", str(st)])
    main(["render", *common, "--spp", "4", "--out", str(o2)])
    assert o1.read_text() == o2.read_text()
