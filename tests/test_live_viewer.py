"""Live map viewer (reference include/Map360_Visualizer.h:95-334 analogue:
a continuously-updating view of the map while SLAM runs, with the freeze /
trajectory-mode keyboard toggles). Headless parity: live.html polls
live.json over HTTP and redraws; these tests exercise the real server and
the payload lifecycle."""

import json
import types
import urllib.request

import numpy as np

from rgbd360_tpu.core.map360 import Map360
from rgbd360_tpu.utils.live_viewer import LiveMapViewer
from rgbd360_tpu.utils.map_html import build_map_data, render_html


def _world(n):
    w = Map360()
    for k in range(n):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 0.3 * k
        w.add_keyframe(types.SimpleNamespace(planes=None), pose)
        if k:
            w.add_connection(k - 1, k, np.eye(4, dtype=np.float32), np.eye(6, dtype=np.float32))
    if n >= 4:  # one non-consecutive connection -> an LC edge in the payload
        w.add_connection(0, n - 1, np.eye(4, dtype=np.float32), np.eye(6, dtype=np.float32))
    return w


def test_live_viewer_serves_and_updates(tmp_path):
    viewer = LiveMapViewer(str(tmp_path), port=0, interval_ms=500)
    try:
        url = viewer.url
        assert url and url.endswith("/live.html")
        html = urllib.request.urlopen(url, timeout=10).read().decode()
        # live mode is baked in: polls live.json, freeze key handler present
        assert "live.json" in html and "const LIVE=true" in html
        assert "__LIVE__" not in html and "__INTERVAL_MS__" not in html
        assert "'k'" in html or '"k"' in html  # bFreezeFrame analogue

        def fetch_json():
            return json.loads(
                urllib.request.urlopen(url.replace("live.html", "live.json"), timeout=10).read()
            )

        assert fetch_json()["traj"] == []  # before the first keyframe
        viewer.update(_world(3))
        d = fetch_json()
        assert len(d["traj"]) == 3 and len(d["frusta"]) == 3 * 8
        viewer.update(_world(6))
        d = fetch_json()
        assert len(d["traj"]) == 6
        assert len(d["lc"]) == 1  # the 0 -> n-1 loop-closure edge
    finally:
        viewer.close()


def test_live_viewer_files_only_mode(tmp_path):
    viewer = LiveMapViewer(str(tmp_path), port=None)
    assert viewer.url is None
    viewer.update(_world(2))
    d = json.loads((tmp_path / "live.json").read_text())
    assert len(d["traj"]) == 2
    viewer.close()


def test_offline_render_stays_static():
    html = render_html(build_map_data(trajectory=[np.eye(4)]), "t")
    assert "const LIVE=false" in html
    assert "__DATA__" not in html


def test_slam_app_live_flag(tmp_path, monkeypatch):
    """--live-view on the KF-SLAM app produces a growing live.json without
    a real dataset: drive main() on a two-frame synthetic wire-format
    sequence (the app path is what ships the viewer updates)."""
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from rgbd360_tpu.apps import kf_sphere_slam

    from tools.make_synthetic_sequence import main as gen

    seq = tmp_path / "seq"
    assert gen(["--out", str(seq), "--frames", "3", "--radius", "0.8"]) == 0
    live = tmp_path / "live"
    rc = kf_sphere_slam.main(
        [str(seq), "--calib-root", str(seq), "--live-view", str(live), "--live-port", "0"]
    )
    assert rc in (0, None)
    d = json.loads((live / "live.json").read_text())
    assert len(d["traj"]) >= 1
