"""Device health tracking: the heartbeat + per-chunk reroute analog.

The reference polls device fatal events every 1 ms on a dedicated thread
(PollingHeartBeat, src/qatzip.c:267-280), flips per-instance heartbeat
status on RESTARTING/RESTARTED/FATAL events (:245-265), and every submit
loop checks it to reroute chunks to SW (:1514-1522).

Device translation: there is no driver event stream, so health is derived
from (a) request outcomes — consecutive device failures trip the breaker —
and (b) an optional low-rate active probe thread that runs a trivial
device op (QATZIP_TPU_HEARTBEAT_S seconds; 0 = passive, the default).
A tripped breaker routes requests to the CPU path for a cooldown, then
allows a single probe request through (the RESTARTING -> RESTARTED
recovery), mirroring the reference's wait_cnt_thrshold retry
(src/qatzip.c:684-687, include/qatzip.h:491-493).
"""
from __future__ import annotations

import os
import threading
import time

FAILURE_TRIP = 3          # consecutive failures that trip the breaker
COOLDOWN_S = 30.0         # breaker-open interval before a probe is allowed
PROBE_TIMEOUT_S = 10.0    # re-offer the probe slot if no outcome arrives


class DeviceHealth:
    def __init__(self):
        self._lock = threading.Lock()
        self._consec_failures = 0
        self._tripped_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        self.total_failures = 0
        self._hb_thread: threading.Thread | None = None

    # -- outcome reporting --------------------------------------------------
    def record_success(self) -> None:
        with self._lock:
            self._consec_failures = 0
            self._tripped_at = 0.0
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self._consec_failures += 1
            self.total_failures += 1
            self._probe_inflight = False
            if self._consec_failures >= FAILURE_TRIP:
                self._tripped_at = time.monotonic()

    # -- routing gate -------------------------------------------------------
    def healthy(self) -> bool:
        """True if the device should receive requests right now.  After a
        trip + cooldown, exactly one caller is admitted as the recovery
        probe; its outcome closes or re-opens the breaker."""
        with self._lock:
            if self._consec_failures < FAILURE_TRIP:
                return True
            now = time.monotonic()
            if now - self._tripped_at < COOLDOWN_S:
                return False
            # Re-offer the probe slot after a timeout: an admitted probe can
            # be rerouted to the CPU by later gates (input_sz_thrshold,
            # devcal) and then never reports an outcome — without expiry the
            # device would stay blacklisted forever.
            if self._probe_inflight and now - self._probe_started < PROBE_TIMEOUT_S:
                return False
            self._probe_inflight = True  # this caller is the probe
            self._probe_started = now
            return True

    # -- optional active heartbeat -----------------------------------------
    def start_heartbeat(self) -> None:
        """Start the active probe thread if QATZIP_TPU_HEARTBEAT_S > 0."""
        interval = float(os.environ.get("QATZIP_TPU_HEARTBEAT_S", "0") or 0)
        if interval <= 0 or self._hb_thread is not None:
            return

        def loop():
            while True:
                time.sleep(interval)
                try:
                    import jax
                    import jax.numpy as jnp

                    jnp.zeros((8,), jnp.int32).block_until_ready()
                    jax.devices()
                    self.record_success()
                except Exception:
                    self.record_failure()

        t = threading.Thread(target=loop, name="qz-heartbeat", daemon=True)
        t.start()
        self._hb_thread = t


health = DeviceHealth()
