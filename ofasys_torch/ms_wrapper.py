"""ModelScope integration (counterpart of ofasys_tpu/ms_wrapper.py).

Registers an OFASys-backed model, preprocessor and pipeline in the
ModelScope registries, so a checkpoint directory can be served with
``modelscope.pipelines.pipeline('ofasys-task', model=...)``. The work is
``OFASys.from_pretrained`` and ``.inference`` (hub_interface.py); the
wrapper only adapts the calling conventions.

Importing this module does nothing unless ``modelscope`` is installed.
"""

from __future__ import annotations

import os

try:  # pragma: no cover - runs only where modelscope is installed
    from modelscope.models.base import Model
    from modelscope.models.builder import MODELS
    from modelscope.pipelines.base import Pipeline
    from modelscope.pipelines.builder import PIPELINES
    from modelscope.preprocessors.base import Preprocessor
    from modelscope.preprocessors.builder import PREPROCESSORS

    _HAS_MODELSCOPE = True
except Exception:  # ModuleNotFoundError and partial installs alike
    _HAS_MODELSCOPE = False

TASK_NAME = "ofasys-task"

if _HAS_MODELSCOPE:  # pragma: no cover - see above

    @MODELS.register_module(TASK_NAME, module_name="ofasys-model")
    class OFASysMsModel(Model):
        """ModelScope Model adapter: ``model_dir`` holds a torch checkpoint
        (a ``Trainer.fit`` save_dir entry). ``device`` is passed to
        ``OFASys.from_pretrained`` (cuda by default)."""

        def __init__(self, model_dir: str, *args, **kwargs):
            super().__init__(model_dir, *args, **kwargs)
            from ofasys_torch.hub_interface import OFASys

            ckpt = kwargs.pop("checkpoint", None) or model_dir
            if os.path.exists(os.path.join(model_dir, "checkpoint_last")):
                ckpt = os.path.join(model_dir, "checkpoint_last")
            self.model = OFASys.from_pretrained(ckpt, device=kwargs.pop("device", "cuda"))

        def forward(self, inputs, **forward_params):
            template = forward_params.pop("instruction", None)
            if template is None:
                raise ValueError(
                    "forward_params must carry 'instruction' (the OFASys slot template, e.g. "
                    "'[IMAGE:img] what does the image describe? -> [TEXT:cap]')")
            return self.model.inference(template, data=inputs, **forward_params)

    @PREPROCESSORS.register_module(TASK_NAME, module_name="ofasys-preprocessor")
    class OFASysMsPreprocessor(Preprocessor):
        """Identity: OFASys preprocessing is slot-driven and happens inside
        ``OFASys.inference`` (GeneralPreprocess)."""

        def __call__(self, data):
            return data

    @PIPELINES.register_module(TASK_NAME, module_name="ofasys-pipeline")
    class OFASysMsPipeline(Pipeline):
        def __init__(self, model, preprocessor=None, **kwargs):
            if isinstance(model, str):
                model = Model.from_pretrained(model)
            if preprocessor is None:
                preprocessor = OFASysMsPreprocessor()
            super().__init__(model=model, preprocessor=preprocessor, auto_collate=False)

        def _sanitize_parameters(self, **kwargs):
            return {}, kwargs, {}

        def preprocess(self, inputs):
            return inputs

        def forward(self, inputs, **forward_params):
            return self.model.forward(inputs, **forward_params)

        def postprocess(self, outputs):
            return outputs
