from .base_sawyer_env import SawyerEnv

__all__ = ['SawyerEnv']
