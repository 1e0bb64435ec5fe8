"""Prompt template registry (reference extras.py:205-817).

A copy of ``onebit_tpu/train/templates.py`` (pure Python), so that the port
imports nothing of the JAX package. A template = prefix + per-turn prompt +
system text + separator (reference ``Template``/``Llama2Template`` +
``register_template``). The set of registered names matches the
reference's 18 templates; each format is the standard public prompt format
of its model family. KD uses ``vanilla``: the raw query with no chrome
(extras.py:422-431).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Template:
    name: str
    prefix: str = "{system}"
    prompt: str = "{query}"
    system: str = ""
    sep: str = ""
    use_history: bool = True

    def render(self, query: str, history: Optional[List[Tuple[str, str]]] = None,
               system: Optional[str] = None) -> str:
        """Render a full prompt (multi-turn history supported)."""
        system = self.system if system is None else system
        parts = []
        prefix = self.prefix.replace("{system}", system)
        if prefix:
            parts.append(prefix)
        if self.use_history and history:
            for q, r in history:
                parts.append(self.prompt.replace("{query}", q) + r)
        parts.append(self.prompt.replace("{query}", query))
        return self.sep.join(parts) if self.sep else "".join(parts)


REGISTRY: Dict[str, Template] = {}


def register_template(t: Template) -> None:
    REGISTRY[t.name] = t


def get_template(name: str) -> Template:
    return REGISTRY[name]


_DEFAULT_SYSTEM = ("A chat between a curious user and an artificial "
                   "intelligence assistant. The assistant gives helpful, "
                   "detailed, and polite answers to the user's questions.")

register_template(Template(
    name="vanilla", prefix="", prompt="{query}", system="", sep="",
    use_history=False))
register_template(Template(
    name="default", prompt="Human: {query}\nAssistant: ",
    system=_DEFAULT_SYSTEM, sep="\n"))
register_template(Template(
    name="llama2", prefix="", prompt="[INST] <<SYS>>\n{system}\n<</SYS>>\n\n"
    "{query} [/INST]".replace("{system}", _DEFAULT_SYSTEM)))
register_template(Template(
    name="llama2_zh", prefix="",
    prompt="[INST] <<SYS>>\nYou are a helpful assistant. 你是一个乐于助人的助手。"
           "\n<</SYS>>\n\n{query} [/INST]"))
register_template(Template(
    name="alpaca", prompt="### Instruction:\n{query}\n\n### Response:\n",
    system=("Below is an instruction that describes a task. "
            "Write a response that appropriately completes the request."),
    sep="\n\n"))
register_template(Template(
    name="vicuna", prompt="USER: {query} ASSISTANT:",
    system=_DEFAULT_SYSTEM))
register_template(Template(
    name="belle", prompt="Human: {query}\n\nBelle: ", sep="\n\n"))
register_template(Template(
    name="ziya", prompt="<human>:{query}\n<bot>:", sep="\n"))
register_template(Template(
    name="aquila", prompt="Human: {query}###Assistant:",
    system=_DEFAULT_SYSTEM, sep="###"))
register_template(Template(
    name="intern", prompt="<|User|>:{query}<eoh>\n<|Bot|>:", sep="<eoa>\n"))
register_template(Template(
    name="baichuan", prefix="", prompt="<reserved_102>{query}<reserved_103>"))
register_template(Template(
    name="baichuan2", prefix="", prompt="<reserved_106>{query}<reserved_107>"))
register_template(Template(
    name="starchat", prefix="<|system|>\n{system}<|end|>",
    prompt="<|user|>\n{query}<|end|>\n<|assistant|>", sep="\n"))
register_template(Template(
    name="chatml", prefix="<|im_start|>system\n{system}<|im_end|>",
    prompt="<|im_start|>user\n{query}<|im_end|>\n<|im_start|>assistant\n",
    system="You are a helpful assistant.", sep="\n"))
register_template(Template(
    name="chatglm2", prefix="", prompt="[Round 1]\n\n问：{query}\n\n答：",
    use_history=True))
register_template(Template(
    name="chatglm3", prefix="<|system|>\n{system}",
    prompt="<|user|>\n{query}<|assistant|>\n"))
register_template(Template(
    name="openchat", prefix="",
    prompt="GPT4 Correct User: {query}<|end_of_turn|>GPT4 Correct Assistant:"))
register_template(Template(
    name="xverse", prompt="Human: {query}\n\nAssistant: "))
