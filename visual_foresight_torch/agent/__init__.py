"""The port's own copies of the JAX package's agents, goal sources and
savers (``visual_foresight_tpu/agent``)."""
from .general_agent import (GeneralAgent, Bad_Traj_Exception, Image_Exception,
                            Environment_Exception)
