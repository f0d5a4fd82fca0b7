# import the registered preprocessors so their @register_config side effects
# fire (the ConfigStore's ofasys.preprocess group)
from ofasys_torch.preprocessor import general  # noqa: F401
