"""Declarative camera topic spec (reference ``robot_envs/util/topic_utils.py``).

Crop/flip/resize applied to every frame from a camera stream.  The port's
copy of ``visual_foresight_tpu/envs/robot_envs/util/topic_utils.py``;
OpenCV is imported where a frame is resized, so the module imports without
it."""


class IMTopic:
    def __init__(self, name, height=480, width=640, top=0, bot=0, right=0,
                 left=0, dtype='bgr8', flip=False):
        self._name = name
        self._height, self._width = height, width
        self._top, self._bot = top, bot
        self._right, self._left = right, left
        self._dtype = dtype
        self._flip = flip

    def process_image(self, img):
        assert self._bot + self._top < img.shape[0], \
            'overcrop: bot + top >= image height'
        assert self._right + self._left < img.shape[1], \
            'overcrop: right + left >= image width'
        bot, right = self._bot, self._right
        if bot <= 0:
            bot = -(img.shape[0] + 10)
        if right <= 0:
            right = -(img.shape[1] + 10)
        img = img[self._top:-bot, self._left:-right]
        if self._flip:
            img = img[::-1, ::-1]
        if (self._height, self._width) != img.shape[:2]:
            import cv2
            return cv2.resize(img, (self._width, self._height),
                              interpolation=cv2.INTER_AREA)
        return img

    name = property(lambda self: self._name)
    width = property(lambda self: self._width)
    height = property(lambda self: self._height)
    top = property(lambda self: self._top)
    bot = property(lambda self: self._bot)
    right = property(lambda self: self._right)
    left = property(lambda self: self._left)
    dtype = property(lambda self: self._dtype)
    flip = property(lambda self: self._flip)
