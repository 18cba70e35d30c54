"""MuJoCo environment base using the modern ``mujoco`` 3.x bindings.

Re-designed from reference ``visual_mpc/envs/mujoco_env/base_mujoco_env.py``
(which used mujoco_py 1.50): offscreen EGL rendering per named camera, 3D->pixel
projection for designated/goal pixels, and improvement/final-distance eval.

``mujoco`` is imported when an env is built, not with this module, so that
the port imports whole where MuJoCo is not installed.  Rendering uses
``MUJOCO_GL=egl`` unless the caller has set another backend.
"""

import os

import numpy as np

from visual_foresight_torch.envs.base_env import BaseEnv


def import_mujoco():
    """The ``mujoco`` module, with the EGL backend unless one is set."""
    os.environ.setdefault('MUJOCO_GL', 'egl')
    import mujoco
    return mujoco


class BaseMujocoEnv(BaseEnv):
    def __init__(self, model_path, _hp):
        self._mj = mujoco = import_mujoco()
        self._frame_height = _hp.viewer_image_height
        self._frame_width = _hp.viewer_image_width

        self._model_path = model_path
        self._model = mujoco.MjModel.from_xml_path(model_path)
        if not _hp.render_shadows:
            # Shadow-map rasterization dominates offscreen rendering on
            # software GL (~100 ms/frame with the default 4096^2 map vs
            # ~1 ms without); shadows carry no task information for the
            # 48x64 training frames, so they are off by default.
            self._model.vis.quality.shadowsize = 0
        self._data = mujoco.MjData(self._model)
        mujoco.mj_forward(self._model, self._data)
        self._renderer = None

        self._base_adim, self._base_sdim = None, None  # sim-level dims
        self._adim, self._sdim = None, None            # agent-facing dims
        self.num_objects, self._n_joints = None, None
        self._goal_obj_pose = None
        self._goaldistances = []

        self._ncam = _hp.ncam
        self.cameras = ['cam{}'.format(i) for i in range(self._ncam)]

        self._last_obs = None
        self._hp = _hp
        self._save_buffer = []

    # -- sim plumbing ---------------------------------------------------------
    @property
    def sim_model(self):
        return self._model

    @property
    def sim_data(self):
        return self._data

    def _sim_step(self):
        self._mj.mj_step(self._model, self._data)

    def _forward(self):
        self._mj.mj_forward(self._model, self._data)

    def _set_state(self, qpos, qvel):
        self._data.qpos[:] = qpos
        self._data.qvel[:] = qvel
        self._mj.mj_forward(self._model, self._data)

    def _default_hparams(self):
        parent_params = super()._default_hparams()
        parent_params.add_hparam('viewer_image_height', 480)
        parent_params.add_hparam('viewer_image_width', 640)
        parent_params.add_hparam('ncam', 1)
        parent_params.add_hparam('render_shadows', False)
        return parent_params

    def set_goal_obj_pose(self, pose):
        self._goal_obj_pose = pose

    def _reset_eval(self):
        if self._goal_obj_pose is not None:
            self._goaldistances = [self.get_distance_score()]

    def reset(self):
        self._save_buffer = []

    # -- rendering -------------------------------------------------------------
    def _get_renderer(self):
        if self._renderer is None:
            self._renderer = self._mj.Renderer(
                self._model, self._frame_height, self._frame_width)
        return self._renderer

    def close(self):
        """Free the offscreen renderer's EGL context deterministically.

        With ``gen_xml: 1`` a collection campaign builds a fresh env (and so
        a fresh ``mujoco.Renderer`` / EGL context) every trajectory; relying
        on GC-time ``__del__`` leaks contexts until ``eglCreateContext``
        starts failing, after which every rollout dies and the campaign
        aborts with ``Bad_Traj_Exception`` (after about 8 trajectories).  The agent calls this before replacing the env."""
        renderer = getattr(self, '_renderer', None)
        self._renderer = None
        if renderer is not None:
            try:
                renderer.close()
            except Exception:
                pass  # EGL display may already be torn down at interpreter exit

    def __del__(self):
        self.close()

    def render(self):
        """Render every camera; returns (ncam, H, W, 3) uint8."""
        renderer = self._get_renderer()
        images = np.zeros((self._ncam, self._frame_height, self._frame_width, 3),
                          dtype=np.uint8)
        for i, cam in enumerate(self.cameras):
            renderer.update_scene(self._data, camera=cam)
            images[i] = renderer.render()
        self._append_save_buffer(images[0])
        return images

    def _append_save_buffer(self, img):
        self._save_buffer.append(img.copy())

    # -- projection --------------------------------------------------------------
    def project_point(self, point, camera):
        """Project a world point into (row, col) pixel coordinates of ``camera``
        using a standard perspective matrix built from the camera fovy
        (same construction as reference ``base_mujoco_env.py:65-88``)."""
        cam_id = self._mj.mj_name2id(self._model,
                                     self._mj.mjtObj.mjOBJ_CAMERA, camera)
        cam_xmat = self._data.cam_xmat[cam_id].reshape(3, 3)
        cam_xpos = self._data.cam_xpos[cam_id]

        # camera frame: columns of cam_xmat are the camera axes in world
        # coordinates; the camera looks along -z_cam
        p_cam = cam_xmat.T.dot(np.asarray(point, dtype=np.float64) - cam_xpos)
        depth = -p_cam[2]
        if depth <= 1e-9:
            depth = 1e-9  # point behind camera; degenerate but keep finite

        fovy_radians = np.deg2rad(self._model.cam_fovy[cam_id])
        uh = 1.0 / np.tan(fovy_radians / 2)            # vertical focal scale
        uw = uh * self._frame_height / self._frame_width  # horizontal (fovx = fovy*aspect)

        ndc_x = uw * p_cam[0] / depth
        ndc_y = uh * p_cam[1] / depth
        col = (ndc_x + 1) * self._frame_width / 2
        row = (-ndc_y + 1) * self._frame_height / 2
        # modern mujoco.Renderer returns images with row 0 at the top, so no
        # height flip is needed (validated in tests/test_mujoco_env.py against
        # the rendered object centroid)
        return float(row), float(col)

    def get_desig_pix(self, target_width, round=True, obj_poses=None):
        qpos_dim = self._n_joints
        assert self._data.qpos.shape[0] == qpos_dim + 7 * self.num_objects
        desig_pix = np.zeros([self._ncam, self.num_objects, 2], dtype=np.int64)
        ratio = self._frame_width / target_width
        for icam, cam in enumerate(self.cameras):
            for i in range(self.num_objects):
                if obj_poses is None:
                    fullpose = self._data.qpos[i * 7 + qpos_dim:(i + 1) * 7 + qpos_dim]
                    chosen_point = fullpose[:3]
                else:
                    chosen_point = obj_poses[i, :3]
                d = np.stack(self.project_point(chosen_point, cam)) / ratio
                if round:
                    d = np.around(d).astype(np.int64)
                desig_pix[icam, i] = d.squeeze()
        return desig_pix

    def get_goal_pix(self, target_width, round=True):
        goal_pix = np.zeros([self._ncam, self.num_objects, 2], dtype=np.int64)
        ratio = self._frame_width / target_width
        for icam, cam in enumerate(self.cameras):
            for i in range(self.num_objects):
                g = np.stack(self.project_point(self._goal_obj_pose[i, :3], cam)) / ratio
                if round:
                    g = np.around(g).astype(np.int64)
                goal_pix[icam, i] = g.squeeze()
        return goal_pix

    # -- scoring -------------------------------------------------------------------
    def eval(self, target_width=None, save_dir=None, ntasks=None):
        self._goaldistances.append(self.get_distance_score())
        return {'improvement': self._goaldistances[0] - self._goaldistances[-1],
                'initial_dist': self._goaldistances[0],
                'final_dist': self._goaldistances[-1]}

    def get_distance_score(self):
        """Mean distance between each object and its goal position."""
        dists = []
        for i_ob in range(self.num_objects):
            goal_pos = self._goal_obj_pose[i_ob, :3]
            curr_pos = self._data.qpos[self._n_joints + i_ob * 7:
                                       self._n_joints + 3 + i_ob * 7]
            dists.append(np.linalg.norm(goal_pos - curr_pos))
        return np.mean(np.array(dists))

    @property
    def adim(self):
        return self._adim

    @property
    def sdim(self):
        return self._sdim

    @property
    def ncam(self):
        return self._ncam

    def generate_task(self):
        raise NotImplementedError

    def save_recording(self, save_worker, i_traj):
        if len(self._save_buffer):
            save_worker.put(('mov', 'traj_{}.gif'.format(i_traj), self._save_buffer))
