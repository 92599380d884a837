"""The frozen bytes counts and the peak they are read against."""

import pytest

from pbench import roofline


def test_fused_window_bytes_at_config_3():
    # PERF.md's bound for the fused window: 805,326,848 bytes, 0.2404 ms at 3.35 TB/s
    nbytes = roofline.fused_window_bytes(5, 32768, 4096)
    assert nbytes == 805_326_848
    assert roofline.share_pct(nbytes, 0.2404e-3) == pytest.approx(100.0, abs=0.01)


def test_kv_op_bytes_at_ycsb_records():
    # 23-byte keys, 1000-byte records: an update reads its key and value and
    # its slot's key and writes the slot's value, length and version; a read
    # reads its key and its slot's key, version, length and value, and
    # writes the found byte, version, length and value
    per = roofline.kv_op_bytes(23, 1000)
    assert per == {"set": 27 + 1004 + 27 + 1008, "get": 27 + 27 + 1008 + 1 + 8 + 1000}


def test_no_share_without_kernel_time():
    assert roofline.share_pct(1000, 0.0) is None
    assert roofline.share_pct(0, 1.0) is None
