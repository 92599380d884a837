"""The port's operations command line (``python -m rabia_tpu_torch``),
from the reference's ``rabia_tpu/__main__.py``.

- the environment report (tests/test_core_types.py's
  ``test_main_module_environment_report``): version, torch and its CUDA
  build, the card, nvcc, and the native-component lines;
- ``--selftest --device cpu``: the slot pipeline deciding, the fault
  path under loss with two replicas down, a MeshEngine commit with three
  replicas agreeing (the plain versions on the CPU); without a card and
  without ``--device`` it raises rather than running on the CPU;
- ``trace`` end to end against a live gateway cluster
  (tests/test_flight.py's ``test_trace_cli_end_to_end``), and ``stats``,
  ``profile``, ``timeline`` and ``ring`` against the same cluster.

The ``slowlog``, ``fleet-top`` and ``wal-dump`` cases live with their
areas (test_torch_critpath.py, test_torch_fleet_obs.py,
test_torch_wal.py).
"""

from __future__ import annotations

import asyncio
import json

import pytest
import torch

from rabia_tpu_torch.__main__ import main


def test_main_module_environment_report(capsys):
    assert main([]) == 0
    out = capsys.readouterr().out
    assert "rabia-tpu" in out
    assert "native codec" in out
    assert "native TCP transport" in out
    assert f"torch {torch.__version__}" in out
    assert "nvcc:" in out and "card:" in out


def test_selftest_on_cpu(capsys):
    assert main(["--selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "selftest OK" in out
    assert "3 replicas agree" in out and "decided every shard" in out


def test_selftest_needs_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--selftest"])


@pytest.mark.asyncio
async def test_trace_and_admin_commands_end_to_end(tmp_path, capsys):
    """One command through a 3-replica gateway cluster, then the real
    console entry points on a worker thread (each runs its own
    asyncio.run): the cross-replica trace, and the admin scrapes."""
    from rabia_tpu_torch.apps.kvstore import encode_set_bin
    from rabia_tpu_torch.gateway.client import RabiaClient
    from rabia_tpu_torch.testing.gateway_cluster import GatewayCluster

    cluster = GatewayCluster(n_replicas=3, n_shards=2)
    await cluster.start()
    client = None
    try:
        client = RabiaClient(cluster.endpoints())
        await client.connect()
        assert await client.submit(0, [encode_set_bin("tracer", "42")])
        addrs = [f"127.0.0.1:{g.port}" for g in cluster.gateways]
        rc = await asyncio.to_thread(
            main, ["trace", *addrs, "--client", str(client.client_id), "--seq", "1"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "submit" in out and "decide" in out
        assert await asyncio.to_thread(main, ["stats", addrs[0], "--kind", "health"]) == 0
        assert json.loads(capsys.readouterr().out)["has_quorum"] is True
        assert await asyncio.to_thread(main, ["stats", addrs[0]]) == 0
        assert "rabia_" in capsys.readouterr().out
        assert await asyncio.to_thread(main, ["profile", addrs[0], "--seconds", "0.2"]) == 0
        timeline = tmp_path / "timeline.json"
        assert await asyncio.to_thread(
            main, ["timeline", *addrs, "--json", "--out", str(timeline)]) == 0
        assert timeline.exists()
    finally:
        if client is not None:
            await client.close()
        await cluster.stop()
