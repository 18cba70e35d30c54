"""Camera subscriber with liveness watchdogs
(reference ``robot_envs/util/camera_recorder.py``).

A mutex-guarded latest-frame buffer fed by either a ROS image topic (when
rospy is available) or the framework's native shared-memory camera node
(``native/camera_stream``).  Includes the sha256 repeated-frame watchdog (a
frozen camera driver keeps publishing the same frame — detect and abort) and
an optional OpenCV tracker for designated pixels.

The port's copy of ``visual_foresight_tpu/envs/robot_envs/util/
camera_recorder.py``: OpenCV is imported where a tracker is made, and the
native source is the port's own client (``visual_foresight_torch/native/
camera_client.py``), which reads the JAX package's node as well.
"""

import hashlib
import threading
import time

import numpy as np


class LatestObservation:
    def __init__(self, save_buffer=False, tracking=False):
        self.img = None
        self.tstamp_img = None
        self.mutex = threading.Lock()
        self.first_sema = threading.Semaphore(value=0)
        self.save_itr = 0
        if save_buffer:
            self.reset_saver()
        if tracking:
            self.reset_tracker()

    def reset_saver(self):
        self.save_buffer = []

    def reset_tracker(self):
        import cv2
        self.cv2_tracker = cv2.TrackerMIL_create() if \
            hasattr(cv2, 'TrackerMIL_create') else None
        self.bbox = None
        self.track_itr = 0


class CameraRecorder:
    TRACK_SKIP = 2
    REPEAT_LIMIT = 100

    def __init__(self, topic_data, opencv_tracking=False, save_videos=False):
        self._tracking_enabled, self._save_vides = opencv_tracking, save_videos
        self._topic_data = topic_data
        self._image_dtype = topic_data.dtype
        self._is_tracking = False

        self._latest_image = LatestObservation(save_videos, opencv_tracking)
        self._saving = False
        self._fps = 30.0

        self._last_hash, self._num_repeats = None, 0
        self._last_hash_get_image = None

        self._stop = threading.Event()
        self._source = self._connect()
        self._latest_image.first_sema.acquire()
        print('done connecting to camera {}'.format(topic_data.name))

    # -- sources ------------------------------------------------------------------
    def _connect(self):
        """Prefer ROS topic subscription; fall back to the native shm camera
        node (topic name = shm channel) or a V4L2 device path."""
        try:
            import rospy
            from cv_bridge import CvBridge
            from sensor_msgs.msg import Image as Image_msg
            bridge = CvBridge()

            def cb(data):
                img = bridge.imgmsg_to_cv2(data, self._image_dtype)[:, :, :3]
                self.store_latest_im(img)

            rospy.Subscriber(self._topic_data.name, Image_msg, cb)
            return 'ros'
        except ImportError:
            pass

        from visual_foresight_torch.native.camera_client import ShmCameraClient
        client = ShmCameraClient(self._topic_data.name)
        self._poller = threading.Thread(target=self._poll_native,
                                        args=(client,), daemon=True)
        self._poller.start()
        return client

    def _poll_native(self, client):
        try:
            while not self._stop.is_set():
                frame = client.read_frame(timeout=0.5)
                if frame is not None:
                    self.store_latest_im(frame)
        finally:
            client.close()

    def close(self):
        """Stop reading the native ring (a ROS subscription stays)."""
        self._stop.set()
        if self._source != 'ros':
            self._poller.join(timeout=5.0)

    # -- tracking ----------------------------------------------------------------
    def start_tracking(self, start_points):
        assert self._tracking_enabled
        n_desig, xy_dim = start_points.shape
        if n_desig != 1:
            raise NotImplementedError('opencv tracking supports one point')
        if xy_dim != 2:
            raise ValueError('bad start point')

        with self._latest_image.mutex:
            self._latest_image.reset_tracker()
            r, c = start_points[0]
            bbox = (int(c - 8), int(r - 8), 16, 16)
            self._latest_image.cv2_tracker.init(self._latest_image.img, bbox)
            self._latest_image.bbox = bbox
        self._is_tracking = True
        print('tracking started')

    def end_tracking(self):
        with self._latest_image.mutex:
            self._is_tracking = False
            self._latest_image.reset_tracker()

    def get_track(self):
        assert self._tracking_enabled and self._is_tracking
        with self._latest_image.mutex:
            bbox = self._latest_image.bbox
        if bbox is None:
            raise RuntimeError('no track yet')
        c, r, w, h = bbox
        return np.array([[r + h // 2, c + w // 2]], dtype=np.int64)

    # -- recording -----------------------------------------------------------------
    def start_recording(self):
        self._saving = True

    def stop_recording(self):
        self._saving = False

    def reset_recording(self):
        assert not self._saving, 'stop_recording first'
        with self._latest_image.mutex:
            buf = self._latest_image.save_buffer \
                if self._save_vides else []
            if self._save_vides:
                self._latest_image.reset_saver()
        return buf

    # -- frame intake -----------------------------------------------------------------
    def store_latest_im(self, img):
        img = self._proc_image(img)
        now = time.time()
        with self._latest_image.mutex:
            self._latest_image.img = img
            self._latest_image.tstamp_img = now
            self._latest_image.save_itr += 1
            if self._latest_image.save_itr == 1:
                self._latest_image.first_sema.release()

            if self._save_vides and self._saving:
                self._latest_image.save_buffer.append(img.copy())

            if self._is_tracking and \
                    self._latest_image.save_itr % self.TRACK_SKIP == 0 and \
                    self._latest_image.cv2_tracker is not None:
                ok, bbox = self._latest_image.cv2_tracker.update(img)
                if ok:
                    self._latest_image.bbox = tuple(int(v) for v in bbox)

        # liveness: identical frames N times in a row => dead driver
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        if digest == self._last_hash:
            self._num_repeats += 1
        else:
            self._num_repeats = 0
        self._last_hash = digest
        if self._num_repeats >= self.REPEAT_LIMIT:
            raise RuntimeError(
                'camera {} frozen: frame repeated {} times'.format(
                    self._topic_data.name, self._num_repeats))

    def _proc_image(self, img):
        return self._topic_data.process_image(np.asarray(img))

    def get_image(self):
        """:return: (timestamp, frame) of the latest observation"""
        with self._latest_image.mutex:
            if self._latest_image.img is None:
                raise RuntimeError('no frame received yet')
            return self._latest_image.tstamp_img, self._latest_image.img.copy()

    @property
    def img_width(self):
        return self._topic_data.width

    @property
    def img_height(self):
        return self._topic_data.height
