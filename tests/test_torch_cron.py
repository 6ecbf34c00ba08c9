"""The port's cron (gofr_tpu_torch/cron.py) and subscriber
(gofr_tpu_torch/subscriber.py), and their wiring into the App.

The twins of tests/test_cron.py: the 5-field spec (wildcards, steps,
ranges, lists, Sunday as 0), bad specs, and a due job run with a full
Context. Every spec is also matched against the reference's ``Schedule``
over a sweep of times. Then ``App.subscribe`` (a handler that returns
commits its message; one that raises counts a failure and the message is
delivered again) and ``App.add_cron_job`` (one tick of the crontab runs the
job; ``start`` and ``shutdown`` start and stop the ticker), as the
reference's App wires them (gofr_tpu/app.py:733-758, :884-885, :912-913).
"""

import json
import random
import threading
import time

import pytest

from gofr_tpu.cron import Schedule as JSchedule
from gofr_tpu_torch.cron import CronParseError, Schedule


@pytest.fixture()
def mock_container():
    from gofr_tpu_torch.container import new_mock_container

    return new_mock_container()


def t(minute=0, hour=0, mday=1, mon=1, wday_py=0):
    return time.struct_time((2026, mon, mday, hour, minute, 0, wday_py, 1, -1))


def test_wildcards_match_everything():
    s = Schedule("* * * * *")
    assert s.matches(t(minute=59, hour=23))


def test_exact_fields():
    s = Schedule("30 14 1 6 *")
    assert s.matches(t(minute=30, hour=14, mday=1, mon=6))
    assert not s.matches(t(minute=31, hour=14, mday=1, mon=6))


def test_steps_ranges_lists():
    s = Schedule("*/15 9-17 * * 1,3,5")
    # python tm_wday: Mon=0 -> cron Mon=1
    assert s.matches(t(minute=45, hour=9, wday_py=0))     # Monday
    assert not s.matches(t(minute=46, hour=9, wday_py=0))
    assert not s.matches(t(minute=45, hour=8, wday_py=0))
    assert not s.matches(t(minute=45, hour=9, wday_py=1))  # Tuesday


def test_sunday_is_zero():
    s = Schedule("* * * * 0")
    assert s.matches(t(wday_py=6))  # python Sunday=6 -> cron 0


def test_invalid_specs_raise():
    for bad in ("* * * *", "60 * * * *", "* 24 * * *", "a * * * *",
                "*/0 * * * *", "5-1 * * * *"):
        with pytest.raises(CronParseError):
            Schedule(bad)


def test_crontab_runs_due_job(mock_container):
    from gofr_tpu_torch.cron import Crontab

    crontab = Crontab(mock_container)
    ran = []
    crontab.add_job("* * * * *", "always", lambda ctx: ran.append(ctx))
    crontab._tick(time.localtime())
    deadline = time.time() + 2
    while not ran and time.time() < deadline:
        time.sleep(0.01)
    assert ran, "due job did not run"
    # ctx passed to the job is a full Context with the container
    assert ran[0].container is mock_container


def test_crontab_bad_spec_raises(mock_container):
    from gofr_tpu_torch.cron import Crontab

    with pytest.raises(CronParseError):
        Crontab(mock_container).add_job("bad spec", "x", lambda ctx: None)


@pytest.mark.parametrize("spec", ["* * * * *", "*/15 9-17 * * 1,3,5",
                                  "0 0 1 1 *", "5,10-20/5 */6 1-7 */2 0",
                                  "59 23 31 12 6"])
def test_schedule_matches_the_reference(spec):
    ours, ref = Schedule(spec), JSchedule(spec)
    assert (ours.minutes, ours.hours, ours.days, ours.months,
            ours.weekdays) == (ref.minutes, ref.hours, ref.days, ref.months,
                               ref.weekdays)
    rng = random.Random(spec)
    for _ in range(500):
        when = t(minute=rng.randrange(60), hour=rng.randrange(24),
                 mday=rng.randrange(1, 32), mon=rng.randrange(1, 13),
                 wday_py=rng.randrange(7))
        assert ours.matches(when) == ref.matches(when)


def _app(**extra):
    from gofr_tpu_torch.app import App

    return App(config={"HTTP_PORT": "0", "METRICS_PORT": "0",
                       "LOG_LEVEL": "FATAL", "PUBSUB_BACKEND": "inproc",
                       **extra})


def _wait(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_app_subscribe_commits_on_success_and_redelivers_on_failure():
    app = _app(CONSUMER_ID="workers")
    seen, failures = [], []

    @app.subscribe("orders")
    def handle(ctx):
        body = ctx.bind()
        if body.get("fail") and not failures:
            failures.append(body)
            raise RuntimeError("transient")
        seen.append(body)

    app.start()
    broker = app.container.pubsub
    try:
        broker.publish("orders", json.dumps({"id": 1}).encode())
        broker.publish("orders", json.dumps({"id": 2, "fail": True}).encode())
        assert _wait(lambda: len(seen) == 2, 15.0), seen
        assert seen == [{"id": 1}, {"id": 2, "fail": True}]
        assert failures == [{"id": 2, "fail": True}]
        # both committed: the group has nothing left to deliver
        assert broker.subscribe("orders", "workers", timeout_s=0.1) is None
        text = app.container.metrics_manager.expose()
        assert "app_pubsub_subscribe_failure_count" in text
    finally:
        app.shutdown()


def test_app_subscribe_without_a_broker_registers_nothing():
    from gofr_tpu_torch.app import App

    app = App(config={"HTTP_PORT": "0", "METRICS_PORT": "0",
                      "LOG_LEVEL": "FATAL"})
    app.subscribe("orders", lambda ctx: None)
    assert app._subscriptions.subscriptions == {}


def test_app_cron_job_runs_on_its_tick_and_stops_with_the_app():
    app = _app()
    ran = threading.Event()
    got = {}

    def job(ctx):
        got["host"] = ctx.host_name()
        got["container"] = ctx.container
        ran.set()

    app.add_cron_job("* * * * *", "every-minute", job)
    with pytest.raises(CronParseError):
        app.add_cron_job("61 * * * *", "bad", job)
    app.start()
    try:
        # the ticker fires at the first whole minute it sees; one tick by
        # hand runs every due job at once
        app._cron._tick(time.localtime())
        assert ran.wait(10.0)
        assert got == {"host": "cron://", "container": app.container}
        assert app._cron._thread.is_alive()
    finally:
        app.shutdown()
    app._cron._thread.join(timeout=5.0)
    assert not app._cron._thread.is_alive()
