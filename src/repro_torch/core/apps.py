"""The three evaluated compound inference applications (paper §4.1, Fig. 2).

The paper's CNN/enc-dec model zoo is not in our assigned pool; each app is
rebuilt with the SAME DAG structure, depth and multiplicative-factor
pattern using assigned-pool LM-family tasks (DESIGN.md §6).  Variant
accuracy values are registered metadata exactly as the paper registers
model-card numbers; int8 variants carry the standard ~0.5-1 pt
quantization accuracy dent.  Their product is ``kernels.ops.quant_linear``
(the int8 kernel); as in the JAX package, no served model runs through it
yet, since ``EngineBackend`` ignores ``Variant.quant``.
"""
from __future__ import annotations

from repro_torch.core.taskgraph import Task, TaskGraph, Variant


def social_media() -> TaskGraph:
    """Depth 1: one input fans out to a classify task and a caption task
    (paper: ResNet ∥ GIT).  Both are leaves — two length-2 paths."""
    classify = Task("classify", (
        Variant("granite-3-2b", "granite-3-2b", accuracy=0.823,
                seq_len=256, gen_len=8),
        Variant("gemma-2b", "gemma-2b", accuracy=0.786,
                seq_len=256, gen_len=8),
        Variant("gemma-2b-int8", "gemma-2b", accuracy=0.779, quant="int8",
                seq_len=256, gen_len=8),
    ))
    caption = Task("caption", (
        Variant("qwen2-7b", "qwen2-7b", accuracy=0.884,
                seq_len=256, gen_len=48),
        Variant("qwen2-7b-int8", "qwen2-7b", accuracy=0.876, quant="int8",
                seq_len=256, gen_len=48),
        Variant("gemma-2b", "gemma-2b", accuracy=0.801,
                seq_len=256, gen_len=48),
    ))
    ingest = Task("ingest", (
        Variant("gemma-2b", "gemma-2b", accuracy=0.995,
                seq_len=128, gen_len=0),
    ))
    return TaskGraph(
        name="social_media",
        tasks={t.name: t for t in (ingest, classify, caption)},
        edges=[("ingest", "classify"), ("ingest", "caption")],
        mult={("ingest", "gemma-2b", "classify"): 1.0,
              ("ingest", "gemma-2b", "caption"): 1.0},
        slo_latency_ms=700.0,            # paper §4.4
        slo_accuracy=0.90,
        path_fractions={("ingest", "classify"): 0.5,
                        ("ingest", "caption"): 0.5},
    )


def traffic_analysis() -> TaskGraph:
    """Depth 2: detector fans out per detection (paper: YOLO → EfficientNet
    per car, VGG per person; avg factors 1.5 / 2.0)."""
    detect = Task("detect", (
        Variant("qwen2-7b", "qwen2-7b", accuracy=0.902,
                seq_len=512, gen_len=16),
        Variant("gemma-2b", "gemma-2b", accuracy=0.857,
                seq_len=512, gen_len=16),
        Variant("gemma-2b-int8", "gemma-2b", accuracy=0.849, quant="int8",
                seq_len=512, gen_len=16),
    ))
    vehicle = Task("vehicle_attrs", (
        Variant("granite-3-2b", "granite-3-2b", accuracy=0.871,
                seq_len=128, gen_len=8),
        Variant("granite-3-2b-int8", "granite-3-2b", accuracy=0.864,
                quant="int8", seq_len=128, gen_len=8),
        Variant("gemma-2b-int8", "gemma-2b", accuracy=0.812, quant="int8",
                seq_len=128, gen_len=8),
    ))
    person = Task("person_attrs", (
        Variant("granite-3-2b", "granite-3-2b", accuracy=0.845,
                seq_len=128, gen_len=8),
        Variant("gemma-2b", "gemma-2b", accuracy=0.809,
                seq_len=128, gen_len=8),
        Variant("gemma-2b-int8", "gemma-2b", accuracy=0.801, quant="int8",
                seq_len=128, gen_len=8),
    ))
    # multiplicative factors: better detectors find more objects
    mult = {}
    for v, cars, people in (("qwen2-7b", 1.5, 2.0),
                            ("gemma-2b", 1.35, 1.8),
                            ("gemma-2b-int8", 1.33, 1.78)):
        mult[("detect", v, "vehicle_attrs")] = cars
        mult[("detect", v, "person_attrs")] = people
    return TaskGraph(
        name="traffic_analysis",
        tasks={t.name: t for t in (detect, vehicle, person)},
        edges=[("detect", "vehicle_attrs"), ("detect", "person_attrs")],
        mult=mult,
        slo_latency_ms=650.0,
        slo_accuracy=0.90,
        path_fractions={("detect", "vehicle_attrs"): 0.5,
                        ("detect", "person_attrs"): 0.5},
    )


def ar_assistant() -> TaskGraph:
    """Depth 3 chain (paper: YOLO → GIT → TTS). Here: VLM detect →
    caption → musicgen TTS over EnCodec tokens."""
    detect = Task("detect", (
        Variant("pixtral-12b", "pixtral-12b", accuracy=0.913,
                seq_len=1024, gen_len=16),
        Variant("pixtral-12b-int8", "pixtral-12b", accuracy=0.905,
                quant="int8", seq_len=1024, gen_len=16),
        Variant("qwen2-7b", "qwen2-7b", accuracy=0.858,
                seq_len=1024, gen_len=16),
    ))
    caption = Task("caption", (
        Variant("qwen2-7b", "qwen2-7b", accuracy=0.884,
                seq_len=256, gen_len=48),
        Variant("qwen2-7b-int8", "qwen2-7b", accuracy=0.876, quant="int8",
                seq_len=256, gen_len=48),
        Variant("gemma-2b", "gemma-2b", accuracy=0.801,
                seq_len=256, gen_len=48),
    ))
    tts = Task("tts", (
        Variant("musicgen-large", "musicgen-large", accuracy=0.924,
                seq_len=256, gen_len=256),
        Variant("musicgen-large-int8", "musicgen-large", accuracy=0.917,
                quant="int8", seq_len=256, gen_len=256),
    ))
    return TaskGraph(
        name="ar_assistant",
        tasks={t.name: t for t in (detect, caption, tts)},
        edges=[("detect", "caption"), ("caption", "tts")],
        mult={("detect", "pixtral-12b", "caption"): 1.2,
              ("detect", "pixtral-12b-int8", "caption"): 1.2,
              ("detect", "qwen2-7b", "caption"): 1.1},
        slo_latency_ms=1550.0,
        slo_accuracy=0.90,
    )


APPS = {
    "social_media": social_media,
    "traffic_analysis": traffic_analysis,
    "ar_assistant": ar_assistant,
}


def get_app(name: str) -> TaskGraph:
    return APPS[name]()
