"""Touch-sensor helpers (reference ``cartgripper_env/util/sensor_util.py``)."""


def is_touching(finger_sensors):
    """True when BOTH finger touch sensors report contact."""
    return finger_sensors[0] > 0 and finger_sensors[1] > 0
