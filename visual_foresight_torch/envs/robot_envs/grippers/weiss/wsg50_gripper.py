"""WSG-50 gripper driver (reference ``grippers/weiss/wsg50_gripper.py``).

Status-subscriber thread with mutex-guarded state, per-command semaphores,
a timeout watchdog (kills the node if the status stream stalls) and force
integration.  Requires ROS + the ``wsg_50_common`` package at runtime.

The port's copy of
``visual_foresight_tpu/envs/robot_envs/grippers/weiss/wsg50_gripper.py``.
"""

import threading
import time

import numpy as np

from ..gripper import GripperInterface

GRIPPER_CLOSE = 6.0     # mm
GRIPPER_OPEN = 96.0     # mm


class WSG50Gripper(GripperInterface):
    def __init__(self):
        import rospy
        from wsg_50_common.msg import Cmd, Status
        self._rospy = rospy
        self._Cmd = Cmd

        self._status_mutex = threading.Lock()
        self._desired_gpos = GRIPPER_OPEN
        self._gripper_speed = 300.0

        self._force_counter = 0
        self._integrate_gripper_force, self._last_integrate = 0.0, None
        self._last_status_t = time.time()
        self.num_timeouts = 0

        self.gripper_pos, self._gripper_force = None, None
        self.gripper_pub = rospy.Publisher('/wsg_50_driver/goal_position',
                                           Cmd, queue_size=10)
        rospy.Subscriber('/wsg_50_driver/status', Status,
                         self._gripper_callback)

        print('waiting for first gripper status...')
        self.sem_list = [threading.Semaphore(value=0)]
        self.sem_list[0].acquire()
        print('gripper ready')

        self._bg = threading.Thread(target=self._background_monitor,
                                    daemon=True)
        self._bg.start()

    @property
    def GRIPPER_CLOSE(self):
        return GRIPPER_CLOSE

    @property
    def GRIPPER_OPEN(self):
        return GRIPPER_OPEN

    def _background_monitor(self):
        while not self._rospy.is_shutdown():
            time.sleep(0.5)
            with self._status_mutex:
                stalled = time.time() - self._last_status_t > 10.0
            if stalled:
                self.num_timeouts += 1
                print('WSG50 STATUS STALLED ({} timeouts)'.format(
                    self.num_timeouts))
                if self.num_timeouts >= 3:
                    self._rospy.signal_shutdown('gripper status dead')
            # republish the target (driver drops commands occasionally)
            cmd = self._Cmd()
            with self._status_mutex:
                cmd.pos = self._desired_gpos
                cmd.speed = self._gripper_speed
            self.gripper_pub.publish(cmd)

    def _gripper_callback(self, status):
        with self._status_mutex:
            self.gripper_pos = status.width
            self._gripper_force = status.force
            self._last_status_t = time.time()

            now = time.time()
            if self._last_integrate is not None:
                self._integrate_gripper_force += status.force * \
                    (now - self._last_integrate)
            self._last_integrate = now

            for sem in self.sem_list:
                sem.release()
            self.sem_list = []

    def get_gripper_state(self, integrate_force=False):
        with self._status_mutex:
            if integrate_force:
                force = self._integrate_gripper_force
                self._integrate_gripper_force = 0.0
                self._last_integrate = None
            else:
                force = self._gripper_force
            return self.gripper_pos, force

    def get_gripper_limits(self):
        return GRIPPER_CLOSE, GRIPPER_OPEN

    def set_gripper(self, position, wait=False):
        with self._status_mutex:
            self._desired_gpos = float(np.clip(position, GRIPPER_CLOSE,
                                               GRIPPER_OPEN))
        cmd = self._Cmd()
        cmd.pos = self._desired_gpos
        cmd.speed = self._gripper_speed
        self.gripper_pub.publish(cmd)
        if wait:
            sem = threading.Semaphore(value=0)
            with self._status_mutex:
                self.sem_list.append(sem)
            if not sem.acquire(timeout=15.0):
                raise RuntimeError('gripper command timed out')

    def set_gripper_speed(self, new_speed):
        assert 1.0 <= new_speed <= 600.0
        self._gripper_speed = new_speed
