"""Background record sync.

The reference used a ray remote task solely to rsync ``/result`` to a master
node every 10 s (``visual_mpc/sim/util/synchronize_tfrecs.py:7-18``); a plain
daemon thread shelling out to rsync (or copytree fallback) provides the same
capability without a cluster framework.

The port's own copy of ``visual_foresight_tpu/sim/util/synchronize_tfrecs.py``,
with one change: ``stop()`` waits for the thread's last copy, so the data
are at ``master_datadir`` when the runner returns (the JAX package sets the
stop event and leaves the last copy to the daemon thread).
"""

import os
import shutil
import subprocess
import threading


def _sync_once(src, dst):
    if shutil.which('rsync'):
        subprocess.run(['rsync', '-a', src.rstrip('/') + '/', dst], check=False)
    else:
        os.makedirs(dst, exist_ok=True)
        shutil.copytree(src, dst, dirs_exist_ok=True)


class SyncThread(threading.Thread):
    """Copies ``src`` into ``dst`` every ``interval`` seconds until
    ``stop()``, then once more."""

    def __init__(self, src, dst, interval):
        super().__init__(daemon=True)
        self.src, self.dst, self.interval = src, dst, interval
        self._stop_event = threading.Event()

    def run(self):
        while not self._stop_event.is_set():
            try:
                _sync_once(self.src, self.dst)
            except Exception as e:  # sync must never kill collection
                print('sync error:', e)
            self._stop_event.wait(self.interval)
        _sync_once(self.src, self.dst)  # final flush

    def stop(self, timeout=None):
        """Ask for the last copy and wait for it (at most ``timeout``
        seconds)."""
        self._stop_event.set()
        self.join(timeout)


def start_sync_thread(agent_params, interval=10.0):
    """Start a daemon thread syncing the agent's data_save_dir to
    ``master_datadir`` every ``interval`` seconds; returns the thread."""
    thread = SyncThread(agent_params.get('data_save_dir', '/result/'),
                        agent_params['master_datadir'], interval)
    thread.start()
    return thread
