"""The task zoo (counterpart of ofasys_tpu/task/tasks.py): 30 registered
task families, each a thin subclass that sets a default instruction
template, criterion and metrics, and a raw-record ``preprocess`` hook,
under ofasys_tpu's registry names and class names.

Data columns follow each task's TSV conventions; the templates are
defaults, overridden by ``Task(..., instruction=...)`` or a config file.
Every family builds, parses its template and initializes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
import string
from typing import Any, Dict, Optional

import numpy as np

from ofasys_torch import ModalityType
from ofasys_torch.configure.config_store import register_config
from ofasys_torch.task.base import Task, TaskConfig
from ofasys_torch.task.traverse_task import TraverseTask, TraverseTaskConfig

_PUNCT_RE = re.compile(f"[{re.escape(string.punctuation)}]")


def _strip_punct(s: str) -> str:
    return " ".join(_PUNCT_RE.sub("", s).strip().split())


def _task(name, template, criterion="label_smoothed_cross_entropy", metrics=(), base=Task,
          config_cls=None):
    """Build and register a thin task class."""

    cfg_cls = config_cls or (TraverseTaskConfig if issubclass(base, TraverseTask) else TaskConfig)

    def __init__(self, cfg=None, **kwargs):
        base.__init__(self, cfg, **kwargs)
        if not self.cfg.instruction.template:
            self.cfg.instruction.template = template
        if self.cfg.criterion == "label_smoothed_cross_entropy" and criterion != "label_smoothed_cross_entropy":
            self.cfg.criterion = criterion
        if not self.cfg.evaluation.metrics and metrics:
            self.cfg.evaluation.metrics = tuple(metrics)
        self.cfg.name = self.cfg.name if self.cfg.name != "default" else name

    cls = type(f"{name.title().replace('_', '')}Task", (base,), {"__init__": __init__})
    return register_config("ofasys.task", name, cfg_cls)(cls)


# ----------------------------------------------------------------- image
@register_config("ofasys.task", "caption", TaskConfig)
class CaptionTask(Task):
    """Image captioning."""

    def __init__(self, cfg=None, **kwargs):
        super().__init__(cfg, **kwargs)
        if not self.cfg.instruction.template:
            self.cfg.instruction.template = "[IMAGE:img] what does the image describe? -> [TEXT:cap]"
        if not self.cfg.evaluation.metrics:
            self.cfg.evaluation.metrics = ("cider", "bleu")
        if self.cfg.name == "default":
            self.cfg.name = "caption"

    def preprocess(self, data: Dict[str, Any], split: str) -> Optional[Dict[str, Any]]:
        cap = data.get("cap")
        if cap is not None:
            cap = str(cap).lower()
            if split == "train":
                cap = " ".join(_strip_punct(cap).split()[:64])
            else:
                data["cap_list"] = [_strip_punct(c).strip() for c in cap.split("&&")]
                cap = data["cap_list"][0]
            data["cap"] = cap
        return data


_task("pretrain_caption", "[IMAGE:img] what does the image describe? -> [TEXT:cap]",
      metrics=("cider",))
_task("image_classify",
      "[IMAGE:img] what does the image describe? -> [TEXT:label_name,closed_set]",
      metrics=("accuracy",), base=TraverseTask)
_task("image_infilling", "what is the complete image? [IMAGE:img,mask_ratio=0.5] -> [IMAGE:code,preprocess=image_vqgan,adaptor=image_vqgan]")
_task("image_text_matching",
      '[IMAGE:img] does the image describe " [TEXT:cap] "? -> [TEXT:label,closed_set]',
      metrics=("accuracy",), base=TraverseTask)


@register_config("ofasys.task", "image_gen", TaskConfig)
class ImageGenTask(Task):
    """Text-to-image over VQGAN codes with a best-of-N rerank: the N
    candidates of a prompt are N sampling beams of one decode, every
    candidate's image decodes in one VQGAN pass, and the image_vqgan
    preprocessor's scorer (CLIP where its weights resolve) orders each
    n-best list best-first."""

    def __init__(self, cfg=None, **kwargs):
        super().__init__(cfg, **kwargs)
        if not self.cfg.instruction.template:
            self.cfg.instruction.template = (
                "[TEXT:cap] -> [IMAGE:code,preprocess=image_vqgan,adaptor=image_vqgan]"
            )
        if not self.cfg.evaluation.metrics:
            self.cfg.evaluation.metrics = ("clip_ti",)
        if self.cfg.name == "default":
            self.cfg.name = "image_gen"

    def preprocess(self, data: Dict[str, Any], split: str) -> Optional[Dict[str, Any]]:
        cap = data.get("cap")
        if isinstance(cap, str):
            if "&&" in cap:
                cap = cap.split("&&")[0]
            cap = _strip_punct(cap).strip().lower()
            max_words = 64
            gp = getattr(self, "general_preprocess", None)
            if gp is not None and "text" in gp.name2pre:
                max_words = int(gp.name2pre["text"].cfg.max_src_length)
            data["cap"] = " ".join(cap.split()[:max_words])
        return data

    def build_generator(self, model, **overrides):
        pre = self.general_preprocess.name2pre["image_vqgan"]
        # only <code> tokens decode (None when constraint_decoding is off)
        if pre.constraint_range:
            overrides.setdefault("constraint_range", f"({pre.constraint_range})")
        n = overrides.get("return_n_best", self.cfg.generation.return_n_best)
        if n > 1:
            # best-of-N: N independent sampling streams in one decode
            overrides.setdefault("sampling", True)
            overrides.setdefault("beam_size", n)
        return super().build_generator(model, **overrides)

    def _source_caption(self, sample, b: int) -> Optional[str]:
        """The query text of sample ``b``, decoded from its source TEXT slot."""
        for s in sample["net_input"]["slots"]:
            if s.is_src and s.modality == ModalityType.TEXT and isinstance(s.value, dict):
                toks = np.asarray(s.value.get("inputs"))[b]
                d = self.global_dict
                toks = toks[(toks != d.pad()) & (toks != d.eos()) & (toks != d.bos())]
                return self.general_preprocess.name2pre["text"].decode(toks)
        return None

    def inference(self, model, params, sample, **gen_overrides):
        """Generate, decode every candidate's image in one VQGAN pass, and
        rerank each n-best list by the image_vqgan preprocessor's scorer
        (each hypothesis's ``extra["rerank_score"]``); without a scorer the
        lists keep the decode's order. ``params`` as in ``Task.inference``."""
        self.prepare_inference(model, params)
        if self._generator is None:
            self.build_generator(model, **gen_overrides)
        outputs = self._generator.generate(sample)
        pre = self.general_preprocess.name2pre["image_vqgan"]
        flat = [h for hyps in outputs for h in hyps]
        for h, im in zip(flat, pre.decode_batch([h.tokens for h in flat])):
            h.image = im
        for b, hyps in enumerate(outputs):
            if len(hyps) <= 1:
                continue
            text = self._source_caption(sample, b)
            scores = None if text is None else pre.rerank_scores(np.stack([h.image for h in hyps]), text)
            if scores is None:
                continue
            for h, sc in zip(hyps, scores):
                h.extra = dict(h.extra or {}, rerank_score=float(sc))
            outputs[b] = [hyps[i] for i in np.argsort(-scores)]
        return outputs


# ------------------------------------------------------------------- box
@register_config("ofasys.task", "refcoco", TaskConfig)
class RefcocoTask(Task):
    """Visual grounding: region text -> box."""

    def __init__(self, cfg=None, **kwargs):
        super().__init__(cfg, **kwargs)
        if not self.cfg.instruction.template:
            self.cfg.instruction.template = (
                '[IMAGE:img] which region does the text " [TEXT:text] " describe? -> [BOX:region_coord]'
            )
        if not self.cfg.evaluation.metrics:
            self.cfg.evaluation.metrics = ("iou_acc",)
        g = self.cfg.generation
        g.beam, g.max_len_b, g.min_len = 1, 4, 4
        if self.cfg.name == "default":
            self.cfg.name = "refcoco"

    def preprocess(self, data: Dict[str, Any], split: str) -> Dict[str, Any]:
        # 'x0,y0,x1,y1' string columns
        rc = data.get("region_coord")
        if isinstance(rc, str):
            box = np.asarray([float(v) for v in rc.split(",")], np.float32)
            w = float(data.get("width", 1.0) or 1.0)
            h = float(data.get("height", 1.0) or 1.0)
            data["region_coord"] = {"box": box, "width": w, "height": h}
        return data


_task("grounded_captioning",
      '[IMAGE:img] what does the region describe? region: [BOX:region_coord] -> [TEXT:text]',
      metrics=("cider",))
_task("object_detection",
      '[IMAGE:img] what are the objects in the image? -> [TEXT:objects]')


# ------------------------------------------------------------------ text
_task("text_infilling", "what is the complete text of \" [TEXT:text,mask_ratio=0.3] \"? -> [TEXT:text]")
_task("language_modeling", " -> [TEXT:text]")
_task("gigaword", 'what is the summary of article " [TEXT:src] "? -> [TEXT:tgt]',
      metrics=("rouge",))
_task("natural_instruction_v2", "[TEXT:src] -> [TEXT:tgt]", metrics=("rouge",))


@dataclasses.dataclass
class GlueTaskConfig(TaskConfig):
    # which GLUE subtask to run; drives the prompt template and metric
    subtask: str = "cola"


@register_config("ofasys.task", "glue", GlueTaskConfig)
class GlueTask(TraverseTask):
    """GLUE: a prompt template per subtask, closed-set label scoring.
    ``subtask`` is a config field, so ``--ofasys.task.glue.subtask=mnli``
    and config files both select it."""

    SUBTASK_TEMPLATES = {
        "cola": ' is the text " [TEXT:sentence] " grammatically correct? -> [TEXT:label,closed_set]',
        "sst2": ' is the sentiment of text " [TEXT:sentence] " positive? -> [TEXT:label,closed_set]',
        "mnli": ' can text1 " [TEXT:premise] " imply text2 " [TEXT:hypothesis] "? -> [TEXT:label,closed_set]',
        "qnli": ' does " [TEXT:sentence] " contain the answer to question " [TEXT:question] "? -> [TEXT:label,closed_set]',
        "qqp": ' is question " [TEXT:question1] " and question " [TEXT:question2] " equivalent? -> [TEXT:label,closed_set]',
        "mrpc": ' does text1 " [TEXT:sentence1] " and text2 " [TEXT:sentence2] " have the same semantics? -> [TEXT:label,closed_set]',
        "rte": ' can text1 " [TEXT:sentence1] " imply text2 " [TEXT:sentence2] "? -> [TEXT:label,closed_set]',
        "stsb": ' is the similarity of text1 " [TEXT:sentence1] " and text2 " [TEXT:sentence2] " high? -> [TEXT:label,closed_set]',
    }

    def __init__(self, cfg=None, subtask: Optional[str] = None, **kwargs):
        super().__init__(cfg, **kwargs)
        # the keyword wins over the config field (default "cola")
        self.subtask = subtask or getattr(self.cfg, "subtask", "cola")
        if self.subtask not in self.SUBTASK_TEMPLATES:
            raise ValueError(
                f"unknown GLUE subtask {self.subtask!r}; "
                f"choose from {sorted(self.SUBTASK_TEMPLATES)}")
        if not self.cfg.instruction.template:
            self.cfg.instruction.template = self.SUBTASK_TEMPLATES[self.subtask]
        if not self.cfg.evaluation.metrics:
            self.cfg.evaluation.metrics = (
                ("accuracy",) if self.subtask != "cola" else ("matthews_corrcoef",))
        if self.cfg.name == "default":
            self.cfg.name = f"glue_{self.subtask}"


@register_config("ofasys.task", "sudoku", TaskConfig)
class SudokuTask(Task):
    """Sudoku through STRUCT slots (the struct preprocessor)."""

    def __init__(self, cfg=None, **kwargs):
        super().__init__(cfg, **kwargs)
        if not self.cfg.instruction.template:
            self.cfg.instruction.template = (
                '" [STRUCT:puzzle,preprocess=struct] " solve the sudoku. -> [STRUCT:solution,preprocess=struct]'
            )
        if not self.cfg.evaluation.metrics:
            self.cfg.evaluation.metrics = ("solved_acc",)
        if self.cfg.name == "default":
            self.cfg.name = "sudoku"


_task("dart", 'what is the description of table " [STRUCT:table,preprocess=struct] "? -> [TEXT:text]',
      metrics=("bleu",))
_task("fetaqa",
      'answer the question " [TEXT:question] " from table " [STRUCT:table,preprocess=struct] " -> [TEXT:answer]',
      metrics=("bleu", "rouge"))


@dataclasses.dataclass
class SpiderTaskConfig(TaskConfig):
    # Spider layout root: {database_path}/{db_id}/{db_id}.sqlite
    database_path: Optional[str] = None
    # encode the db id into the target ("db_id | sql")
    target_with_db_id: bool = True


@register_config("ofasys.task", "spider", SpiderTaskConfig)
class SpiderTask(Task):
    """Text-to-SQL with execution accuracy: a record carries a question and
    a db_id; the database's schema, read from its sqlite file
    (``utils/sql_eval.dump_schema``), is linearized into the prompt with the
    question's linked cell values, and ``sql_exec_acc`` runs the predicted
    and the gold SQL on that database."""

    def __init__(self, cfg=None, **kwargs):
        super().__init__(cfg, **kwargs)
        if not self.cfg.instruction.template:
            self.cfg.instruction.template = (
                '" [TEXT:question] " ; structured knowledge: '
                '" [STRUCT:database,preprocess=database] " -> [TEXT:query]'
            )
        if not self.cfg.evaluation.metrics:
            self.cfg.evaluation.metrics = ("exact_match", "sql_match_acc", "sql_exec_acc")
        if self.cfg.name == "default":
            self.cfg.name = "spider"
        self._schema_cache: Dict[str, Any] = {}

    def initialize(self, global_dict, is_train: bool = True):
        super().initialize(global_dict, is_train)
        # point the execution-accuracy metric at this task's database root
        for m in self.metrics:
            if hasattr(m.cfg, "database_path") and self.cfg.database_path:
                m.cfg.database_path = self.cfg.database_path
        return self

    def _db_file(self, db_id: str) -> Optional[str]:
        import os

        root = self.cfg.database_path
        if not root:
            return None
        for cand in (os.path.join(root, db_id, f"{db_id}.sqlite"),
                     os.path.join(root, f"{db_id}.sqlite")):
            if os.path.isfile(cand):
                return cand
        return None

    def preprocess(self, data: Dict[str, Any], split: str) -> Dict[str, Any]:
        db_id = data.get("db_id")
        if db_id and "database" not in data:
            if db_id not in self._schema_cache:
                from ofasys_torch.utils.sql_eval import dump_schema

                db = self._db_file(db_id)
                self._schema_cache[db_id] = (
                    dump_schema(db, db_id) if db else {"db_id": db_id, "tables": {}})
            # a copy per record with the question and the database file, for
            # the database preprocessor's linking of question words to cells
            data["database"] = dict(self._schema_cache[db_id],
                                    question=str(data.get("question", "")),
                                    db_path=self._db_file(db_id) or "")
        q = data.get("query")
        if q is not None:
            q = str(q).lower().replace("<unk>", "unk").strip()
            if db_id and self.cfg.target_with_db_id and not q.startswith(f"{db_id} |"):
                q = f"{db_id} | {q}"
            data["query"] = q
        if "question" in data:
            data["question"] = str(data["question"]).lower().replace("<unk>", "unk").strip()
        return data


# ----------------------------------------------------------------- audio
_task("speech_to_text", "[AUDIO:wav] what is the transcription? -> [TEXT:text]",
      criterion="speech_to_text_loss", metrics=("wer",))
_task("phone_to_text", "[PHONE:phone,preprocess=phone] -> [TEXT:text]", metrics=("wer",))
_task("audio_pretraining", "[AUDIO:wav,mask=true] -> [TEXT:text]",
      criterion="speech_pretrain_loss")


@register_config("ofasys.task", "text_to_speech", TaskConfig)
class TextToSpeechTask(Task):
    """TTS: the ``audio_tgt_fbank`` target under ``ofa_tacotron2``, decoded
    by the AR speech generator and turned to waveforms by the audio
    preprocessor."""

    def __init__(self, cfg=None, **kwargs):
        super().__init__(cfg, **kwargs)
        if not self.cfg.instruction.template:
            self.cfg.instruction.template = "[TEXT:text] -> [AUDIO:wav,adaptor=audio_tgt_fbank]"
        if self.cfg.criterion == "label_smoothed_cross_entropy":
            self.cfg.criterion = "ofa_tacotron2"
        if self.cfg.name == "default":
            self.cfg.name = "text_to_speech"

    def build_generator(self, model, **overrides):
        # the speech generator even under a custom template
        return self.build_speech_generator(model, **overrides)

    def inference(self, model, params, sample, **gen_overrides):
        """One SpeechGeneratorOutput per sample, with its waveform.
        ``params`` as in ``Task.inference``."""
        self.prepare_inference(model, params)
        if self._generator is None:
            self.build_generator(model, **gen_overrides)
        outputs = self._generator.generate(sample)
        self.general_preprocess.postprocess(outputs, sample)
        return outputs


# ----------------------------------------------------------------- video
_task("video_caption", "[VIDEO:video] what does the video describe? -> [TEXT:cap]",
      metrics=("cider",))
_task("video_classify", "[VIDEO:video] what does the video describe? -> [TEXT:label,closed_set]",
      metrics=("accuracy",), base=TraverseTask)
_task("video_question_answering_generative",
      "[VIDEO:video] [TEXT:question] -> [TEXT:answer]", metrics=("accuracy",))


@register_config("ofasys.task", "video_generation", TaskConfig)
class VideoGenerationTask(Task):
    """Conditional frame generation: a per-sample condition index from the
    first frame's hash; the source video's frames from that index on are
    zeroed and the target is the condition frame, generated as VQGAN
    codes."""

    def __init__(self, cfg=None, **kwargs):
        super().__init__(cfg, **kwargs)
        if not self.cfg.instruction.template:
            self.cfg.instruction.template = (
                "[VIDEO:video] -> [IMAGE:frame,preprocess=image_vqgan,adaptor=image_vqgan]"
            )
        if self.cfg.name == "default":
            self.cfg.name = "video_generation"

    def preprocess(self, data: Dict[str, Any], split: str) -> Optional[Dict[str, Any]]:
        video = data.get("video")
        if video is None:
            return data
        frames = np.asarray(video)                       # (T, H, W, C) float/uint8
        if frames.ndim != 4:
            return data
        seed = int(hashlib.md5(
            np.ascontiguousarray(frames[0]).tobytes()
        ).hexdigest()[:8], 16)
        idx = seed % frames.shape[0]
        data["frame"] = frames[idx].copy()
        cond = frames.copy()
        cond[idx:] = 0
        data["video"] = cond
        return data


# ---------------------------------------------------------------- motion
@register_config("ofasys.task", "diffusion", TaskConfig)
class DiffusionTask(Task):
    """Text-to-motion diffusion."""

    def __init__(self, cfg=None, **kwargs):
        super().__init__(cfg, **kwargs)
        if not self.cfg.instruction.template:
            self.cfg.instruction.template = (
                'motion capture: " [TEXT:text] " -> [MOTION:bvh,preprocess=motion_6d,adaptor=motion_6d]'
            )
        if self.cfg.criterion == "label_smoothed_cross_entropy":
            self.cfg.criterion = "diffusion_criterion"
        if self.cfg.name == "default":
            self.cfg.name = "diffusion"

    def build_generator(self, model, **overrides):
        from ofasys_torch.generator import DiffusionGenerator

        pre = self.general_preprocess.name2pre.get("motion_6d")
        overrides.setdefault("clamp_fn", pre.clamp if pre else None)
        self._generator = DiffusionGenerator(model, **overrides)
        return self._generator

    def inference(self, model, params, sample, **gen_overrides):
        if params is not None:
            from ofasys_torch.utils.jax_params import load_jax_params

            load_jax_params(model.net, params)
        if self._generator is None:
            self.build_generator(model, **gen_overrides)
        outputs = self._generator.generate(sample)
        self.general_preprocess.postprocess(outputs, sample)
        return outputs


# ------------------------------------------------------------------- vqa
@register_config("ofasys.task", "vqa_gen", TaskConfig)
class VqaGenTask(Task):
    """Open-ended VQA."""

    def __init__(self, cfg=None, **kwargs):
        super().__init__(cfg, **kwargs)
        if not self.cfg.instruction.template:
            self.cfg.instruction.template = "[IMAGE:img] [TEXT:question] -> [TEXT:answer]"
        if not self.cfg.evaluation.metrics:
            self.cfg.evaluation.metrics = ("vqa_score",)
        if self.cfg.name == "default":
            self.cfg.name = "vqa_gen"

    def preprocess(self, data: Dict[str, Any], split: str) -> Dict[str, Any]:
        ans = data.get("answer")
        if isinstance(ans, str) and "|!+" in ans:
            # 'conf|!+answer' variants
            data["answer"] = ans.split("|!+")[-1]
        return data


_task("snli_ve",
      '[IMAGE:img] can image and text1 " [TEXT:hypothesis] " imply text2 " [TEXT:caption] "? -> [TEXT:label,closed_set]',
      metrics=("accuracy",), base=TraverseTask)
