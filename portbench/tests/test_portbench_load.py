"""Traffic generation and the counts of operations and bytes."""
from __future__ import annotations

import asyncio
import json
import threading
import time

import numpy as np
import pytest

from portbench import count, load
from portbench.tests.conftest import TOY_MODEL, TOY_OFFLINE, qwen2


def test_lognormal_lengths_are_clipped_quantiles():
    x = load.lognormal_lengths(256, 362, 0.52, 128, 1024)
    assert len(x) == 256 and x.min() >= 128 and x.max() <= 1024
    assert np.all(np.diff(x) >= 0)
    assert abs(np.median(x) - 362) <= 4


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, -3])
def test_offline_queue_same_work_for_every_seed(seed):
    t = json.loads(json.dumps(TOY_OFFLINE))
    q = load.OfflineQueue(t, seed, 100)
    lens = [len(q.next()) for _ in range(len(q.pool))]
    assert sorted(lens) == sorted(q.pool.tolist())
    bands = np.sort(q.pool).reshape(t["strata"], -1)
    for r in range(0, len(lens), t["strata"]):
        # every round takes one length from every band
        got = sorted(lens[r:r + t["strata"]])
        assert all(bands[j].min() <= got[j] <= bands[j].max()
                   for j in range(t["strata"]))
    again = load.OfflineQueue(t, seed, 100)
    assert np.array_equal(again.next(), load.OfflineQueue(t, seed, 100).next())


def test_offline_queue_orders_differ_by_seed():
    t = dict(TOY_OFFLINE, pool=64)
    qa, qb = load.OfflineQueue(t, 1, 100), load.OfflineQueue(t, 2, 100)
    la = [len(qa.next()) for _ in range(64)]
    lb = [len(qb.next()) for _ in range(64)]
    assert la != lb and sorted(la) == sorted(lb)


@pytest.mark.parametrize("rate,seconds", [(1.6, 50.0), (4.0, 10.0)])
def test_arrivals_same_gaps_in_another_order(rate, seconds):
    a = load.arrival_offsets(rate, seconds, 1)
    b = load.arrival_offsets(rate, seconds, 2 ** 31 + 5)
    assert len(a) == len(b) == round(rate * seconds)
    assert a[0] == 0.0 and a[-1] < seconds and b[-1] < seconds
    assert np.all(np.diff(a) > 0)
    gaps = load.exponential_gaps(rate, seconds)
    for x in (a, b):
        # n - 1 of the same n gaps, in the seed's order
        assert np.all(np.isclose(np.diff(x)[:, None], gaps[None, :]).any(1))
    assert not np.allclose(np.diff(a), np.diff(b))


def test_open_loop_times_from_the_due_time():
    """A server that answers each request 0.2 s after reading it: each
    latency counts from the due time, and the client sent on time."""
    async def handle(reader, writer):
        await reader.readuntil(b"\r\n\r\n")
        await asyncio.sleep(0.2)
        body = json.dumps({"status": "ok"}).encode()
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        await writer.drain()
        writer.close()

    ready, port = threading.Event(), []
    stop = threading.Event()

    async def serve():
        srv = await asyncio.start_server(handle, "127.0.0.1", 0)
        port.append(srv.sockets[0].getsockname()[1])
        ready.set()
        while not stop.is_set():
            await asyncio.sleep(0.01)
        srv.close()
        await srv.wait_closed()

    th = threading.Thread(target=asyncio.run, args=(serve(),))
    th.start()
    try:
        assert ready.wait(10)
        client = load.OpenLoop("127.0.0.1", port[0], "/v1/x/submit",
                               [0.0, 0.1, 0.3], drain_s=10.0)
        client.start(time.perf_counter())
        client.join(20.0)
        assert client.done()
    finally:
        stop.set()
        th.join(10)
    assert not th.is_alive()
    for s in client.sent:
        assert s.status == 200 and s.body == {"status": "ok"}
        assert 195.0 <= s.latency_ms < 2000.0
    assert client.lateness_ms()["max"] < 500.0


def test_flash_and_decode_work_count_each_pair_once():
    B, S, H, KV, hd = 2, 5, 4, 2, 8
    flops, nbytes = count.flash_work(B, S, H, KV, hd)
    pairs = sum(i + 1 for i in range(S))
    assert flops == 4 * B * H * hd * pairs
    assert nbytes == 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    flops, nbytes = count.decode_work(B, 9, H, KV, hd)
    assert flops == 4 * B * H * hd * 9
    assert nbytes == 2 * (2 * B * H * hd + 2 * B * 9 * KV * hd)
    assert count.least_time_s(989e12, 1.0) == pytest.approx(1.0)
    assert count.least_time_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_sequence_flops_sum_the_steps():
    cfg, fam = TOY_MODEL, qwen2()
    p, n = 11, 5
    L, H, hd = cfg["num_hidden_layers"], 4, 16
    dense = 2 * fam._layer_matmul_params(cfg) * L
    want = dense * p + 4 * H * hd * L * p * (p + 1) // 2
    for j in range(1, n):
        want += dense + 4 * H * hd * L * (p + j)
    want += 2 * cfg["hidden_size"] * cfg["vocab_size"] * n
    assert fam.sequence_flops(cfg, p, n) == pytest.approx(want)


def test_layer_params_match_the_port_s_count():
    cfg, fam = TOY_MODEL, qwen2()
    total, _ = fam._arch_config(cfg).param_count()
    d, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    bias = (4 + 2 * 2) * 16
    norms = 2 * L * d + d
    assert fam._layer_matmul_params(cfg) * L == total - 2 * V * d - norms \
        - L * bias


def test_batch_attention_calls():
    work = qwen2().kernel_work(TOY_MODEL, 3, 10, 4)
    assert set(work) == {"flash", "decode"}
    flash, decode = work["flash"], work["decode"]
    assert len(flash) == 2 and len(decode) == 2 * 3
    assert flash[0] == count.flash_work(3, 10, 4, 2, 16)
    assert decode[0] == count.decode_work(3, 11, 4, 2, 16)
    assert decode[-1] == count.decode_work(3, 13, 4, 2, 16)
