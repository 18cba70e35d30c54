"""Run logger used by controllers and robot code.

Mirrors reference ``visual_mpc/utils/logger.py:3-25``: either appends joined
string fragments to a logfile, prints them, or mutes entirely.  The port's
own copy of ``visual_foresight_tpu/utils/logger.py``.
"""

import os


class Logger(object):
    def __init__(self, logfiledir=None, logfilename=None, printout=False, mute=False):
        self._dir = logfiledir
        self._name = logfilename
        self._printout = printout or logfiledir is None or logfilename is None
        self._mute = mute
        if logfiledir is not None and logfilename is not None:
            path = os.path.join(logfiledir, logfilename)
            if os.path.exists(path):
                os.remove(path)

    @property
    def path(self):
        if self._dir is None or self._name is None:
            return None
        return os.path.join(self._dir, self._name)

    def log(self, *fragments):
        if self._mute:
            return
        if self._printout:
            print(*fragments)
        else:
            line = ''.join(str(f) for f in fragments)
            with open(self.path, 'a') as f:
                f.write(line + '\n')
