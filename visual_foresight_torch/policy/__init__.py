from .policy import Policy, DummyPolicy, NullPolicy, get_policy_args
