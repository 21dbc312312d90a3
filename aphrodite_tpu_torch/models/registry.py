"""Model registry (counterpart of aphrodite_tpu/models/registry.py).

Maps HF ``architectures[0]`` to a model class. The PyTorch package ports
Llama (and the checkpoints that reuse its graph: Mistral, Qwen2 and
Qwen2.5, and the JAX registry's Llama aliases), Qwen3, Baichuan,
Phi-3-Small, Phi-3 (mini, medium), Gemma, Gemma2 and Gemma3, the MoE
models Mixtral, Qwen2-MoE, Qwen3-MoE, OLMoE and PhiMoE, the ALiBi and
multi-query families Bloom, MPT, JAIS and Falcon (with its legacy RW
name), the encoder-decoders T5 (Flan-T5), BART and mBART, and the
partial- and interleaved-rotary families GPT-NeoX (Pythia), Phi (1, 1.5,
2), StableLM, Persimmon, GPT-J, Cohere, Nemotron, GLM-4 and ChatGLM, the
learned-position families GPT-2, GPTBigCode (StarCoder) and OPT, and the
Llama-body families Granite, SmolLM3, DeciLM, StarCoder2, Orion, OLMo,
EXAONE, InternLM2, OLMo2 and MiniCPM (dense and MoE), and MiniCPM3 on the
DeepSeek body's multi-head latent attention so far. Every other
architecture the JAX package serves raises with the ROADMAP item that
holds it (``_WAITING``); any other raises too.
"""

from typing import Dict

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.models.baichuan import (BaiChuanForCausalLM,
                                                 BaichuanForCausalLM)
from aphrodite_tpu_torch.models.bart import (BartForConditionalGeneration,
                                             MBartForConditionalGeneration)
from aphrodite_tpu_torch.models.bloom import BloomForCausalLM
from aphrodite_tpu_torch.models.chatglm import \
    ChatGLMForConditionalGeneration
from aphrodite_tpu_torch.models.cohere import CohereForCausalLM
from aphrodite_tpu_torch.models.decilm import DeciLMForCausalLM
from aphrodite_tpu_torch.models.exaone import ExaoneForCausalLM
from aphrodite_tpu_torch.models.falcon import FalconForCausalLM
from aphrodite_tpu_torch.models.gemma import (Gemma2ForCausalLM,
                                              Gemma3ForCausalLM,
                                              GemmaForCausalLM)
from aphrodite_tpu_torch.models.glm import GlmForCausalLM
from aphrodite_tpu_torch.models.gpt2 import GPT2LMHeadModel
from aphrodite_tpu_torch.models.gpt_bigcode import GPTBigCodeForCausalLM
from aphrodite_tpu_torch.models.gpt_neox import GPTNeoXForCausalLM
from aphrodite_tpu_torch.models.gptj import GPTJForCausalLM
from aphrodite_tpu_torch.models.granite import GraniteForCausalLM
from aphrodite_tpu_torch.models.internlm2 import InternLM2ForCausalLM
from aphrodite_tpu_torch.models.jais import JAISLMHeadModel
from aphrodite_tpu_torch.models.llama import LlamaForCausalLM
from aphrodite_tpu_torch.models.minicpm import (MiniCPM3ForCausalLM,
                                                MiniCPMForCausalLM,
                                                minicpm_class)
from aphrodite_tpu_torch.models.mixtral import MixtralForCausalLM
from aphrodite_tpu_torch.models.mpt import MPTForCausalLM
from aphrodite_tpu_torch.models.nemotron import NemotronForCausalLM
from aphrodite_tpu_torch.models.olmo import OlmoForCausalLM
from aphrodite_tpu_torch.models.olmo2 import Olmo2ForCausalLM
from aphrodite_tpu_torch.models.olmoe import OlmoeForCausalLM
from aphrodite_tpu_torch.models.opt import OPTForCausalLM
from aphrodite_tpu_torch.models.orion import OrionForCausalLM
from aphrodite_tpu_torch.models.persimmon import PersimmonForCausalLM
from aphrodite_tpu_torch.models.phi import PhiForCausalLM
from aphrodite_tpu_torch.models.phi3 import Phi3ForCausalLM
from aphrodite_tpu_torch.models.phi3small import Phi3SmallForCausalLM
from aphrodite_tpu_torch.models.phimoe import PhiMoEForCausalLM
from aphrodite_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM
from aphrodite_tpu_torch.models.qwen3 import Qwen3ForCausalLM
from aphrodite_tpu_torch.models.qwen3_moe import Qwen3MoeForCausalLM
from aphrodite_tpu_torch.models.smollm3 import SmolLM3ForCausalLM
from aphrodite_tpu_torch.models.stablelm import StableLmForCausalLM
from aphrodite_tpu_torch.models.starcoder2 import Starcoder2ForCausalLM
from aphrodite_tpu_torch.models.t5 import T5ForConditionalGeneration


class Qwen2ForCausalLM(LlamaForCausalLM):
    """Qwen2 / Qwen2.5: the Llama topology with q|k|v bias; the small
    variants tie the embeddings (the config's tie_word_embeddings)."""

    attention_bias = True


class MistralForCausalLM(LlamaForCausalLM):
    """Mistral: the Llama topology with the config's sliding window."""


_MODEL_REGISTRY: Dict[str, type] = {
    "LlamaForCausalLM": LlamaForCausalLM,
    "MistralForCausalLM": MistralForCausalLM,
    "Qwen2ForCausalLM": Qwen2ForCausalLM,
    "Qwen3ForCausalLM": Qwen3ForCausalLM,
    # Checkpoints that reuse the Llama graph and names (Aquila /
    # AquilaChat2, InternLM v1, decapoda LLaMA, XVERSE), as in the JAX
    # registry.
    "AquilaModel": LlamaForCausalLM,
    "AquilaForCausalLM": LlamaForCausalLM,
    "InternLMForCausalLM": LlamaForCausalLM,
    "LLaMAForCausalLM": LlamaForCausalLM,
    "XverseForCausalLM": LlamaForCausalLM,
    "BaiChuanForCausalLM": BaiChuanForCausalLM,
    "BaichuanForCausalLM": BaichuanForCausalLM,
    "Phi3SmallForCausalLM": Phi3SmallForCausalLM,
    "GemmaForCausalLM": GemmaForCausalLM,
    "Gemma2ForCausalLM": Gemma2ForCausalLM,
    "Gemma3ForCausalLM": Gemma3ForCausalLM,
    "Phi3ForCausalLM": Phi3ForCausalLM,
    "MixtralForCausalLM": MixtralForCausalLM,
    "Qwen2MoeForCausalLM": Qwen2MoeForCausalLM,
    "Qwen3MoeForCausalLM": Qwen3MoeForCausalLM,
    "OlmoeForCausalLM": OlmoeForCausalLM,
    "PhiMoEForCausalLM": PhiMoEForCausalLM,
    "PhimoeForCausalLM": PhiMoEForCausalLM,
    "BloomForCausalLM": BloomForCausalLM,
    "MptForCausalLM": MPTForCausalLM,
    "MPTForCausalLM": MPTForCausalLM,
    "JAISLMHeadModel": JAISLMHeadModel,
    "FalconForCausalLM": FalconForCausalLM,
    "RWForCausalLM": FalconForCausalLM,
    # Partial and interleaved rotary on the Llama body.
    "GPTNeoXForCausalLM": GPTNeoXForCausalLM,
    "PhiForCausalLM": PhiForCausalLM,
    "StableLmForCausalLM": StableLmForCausalLM,
    "StableLMEpochForCausalLM": StableLmForCausalLM,
    "StablelmForCausalLM": StableLmForCausalLM,
    "PersimmonForCausalLM": PersimmonForCausalLM,
    "GPTJForCausalLM": GPTJForCausalLM,
    "CohereForCausalLM": CohereForCausalLM,
    "NemotronForCausalLM": NemotronForCausalLM,
    "GlmForCausalLM": GlmForCausalLM,
    "ChatGLMModel": ChatGLMForConditionalGeneration,
    "ChatGLMForConditionalGeneration": ChatGLMForConditionalGeneration,
    # Learned positions, and the Llama body's other hooks.
    "GPT2LMHeadModel": GPT2LMHeadModel,
    "GPTBigCodeForCausalLM": GPTBigCodeForCausalLM,
    "OPTForCausalLM": OPTForCausalLM,
    "GraniteForCausalLM": GraniteForCausalLM,
    "SmolLM3ForCausalLM": SmolLM3ForCausalLM,
    "DeciLMForCausalLM": DeciLMForCausalLM,
    "Starcoder2ForCausalLM": Starcoder2ForCausalLM,
    "OrionForCausalLM": OrionForCausalLM,
    "OlmoForCausalLM": OlmoForCausalLM,
    "ExaoneForCausalLM": ExaoneForCausalLM,
    "InternLM2ForCausalLM": InternLM2ForCausalLM,
    "Olmo2ForCausalLM": Olmo2ForCausalLM,
    # The MoE variant where the config names experts (minicpm_class).
    "MiniCPMForCausalLM": MiniCPMForCausalLM,
    "MiniCPM3ForCausalLM": MiniCPM3ForCausalLM,
    # Encoder-decoders, as the JAX registry names them.
    "T5ForConditionalGeneration": T5ForConditionalGeneration,
    "T5WithLMHeadModel": T5ForConditionalGeneration,
    "BartForConditionalGeneration": BartForConditionalGeneration,
    "BartModel": BartForConditionalGeneration,
    "MBartForConditionalGeneration": MBartForConditionalGeneration,
}

# Architectures the JAX package serves and the port does not yet, with what
# each waits for (ROADMAP.md, module queue items 3, 7, 8 and 10).
_DENSE = "the rest of the dense zoo (item 3"
_MULTIMODAL = "its vision or audio tower (item 10, the multimodal towers)"
_WAITING = {
    "SolarForCausalLM": f"{_DENSE}: Solar's bskcn segments)",
    "QWenLMHeadModel": f"{_DENSE}: Qwen v1)",
    "MambaForCausalLM": "the SSMs (item 10)",
    "Mamba2ForCausalLM": "the SSMs (item 10)",
    "JambaForCausalLM": "the SSMs (item 10)",
    "EAGLEModel": "speculative decoding (item 8)",
    **dict.fromkeys((
        "LlavaForConditionalGeneration",
        "LlavaNextForConditionalGeneration",
        "LlavaNextVideoForConditionalGeneration",
        "ChameleonForConditionalGeneration", "ChameleonForCausalLM",
        "InternVLForConditionalGeneration", "InternVLChatModel",
        "PixtralForConditionalGeneration", "UltravoxModel",
        "Qwen2AudioForConditionalGeneration", "MolmoForCausalLM",
        "MiniCPMV", "Qwen2VLForConditionalGeneration",
        "PaliGemmaForConditionalGeneration", "FuyuForCausalLM",
        "Phi3VForCausalLM"), _MULTIMODAL),
    "GraniteMoeForCausalLM": "GraniteMoE's experts (item 7, GraniteMoE)",
    "DbrxForCausalLM": "DBRX's fused expert tensors (item 7, DBRX)",
    "ArcticForCausalLM": "Arctic's residual MoE beside a dense MLP (item 7, "
                         "Arctic)",
    "DeepseekForCausalLM": "DeepSeek's shared experts and dense first "
                           "layers (item 7, DeepSeek)",
    # MLA with its latent cache is ported (models/deepseek.py, MiniCPM3);
    # the routed and shared experts are not, nor the ragged kernel at
    # their latent head_dim of 640.
    "DeepseekV2ForCausalLM": "the MoE half of the DeepSeek body, its "
                             "routed and shared experts and grouped router, "
                             "and head_dim 640 (item 7, DeepSeek V2/V3)",
    "DeepseekV3ForCausalLM": "the MoE half of the DeepSeek body, its "
                             "routed and shared experts and grouped router, "
                             "and head_dim 640 (item 7, DeepSeek V2/V3)",
    "QuantMixtralForCausalLM": "GPTQ/AWQ checkpoints of MoE models (item 7, "
                               "quantized MoE checkpoints)",
    "WhisperForConditionalGeneration": "the audio encoder (item 10, "
                                       "Whisper)",
    "Blip2ForConditionalGeneration": "BLIP-2's vision tower and its splice "
                                     "into T5's encoder (item 10, BLIP2-T5)",
}


# The embedding aliases: the pooling runner (item 10, pooling).
_POOLING = ("MistralModel", "LlamaModel")


def get_model_class(model_config: ModelConfig) -> type:
    arch = model_config.architecture
    if arch in _POOLING:
        raise ValueError(
            f"architecture {arch!r} is not ported to the PyTorch package "
            "yet: the embedding aliases wait for the pooling runner in "
            "ROADMAP.md's module queue (item 10, pooling). The JAX package "
            "(aphrodite_tpu) serves it.")
    if arch in _WAITING:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to the PyTorch package "
            f"yet: it waits for {_WAITING[arch]} in ROADMAP.md's module "
            "queue. The JAX package (aphrodite_tpu) serves it.")
    if arch == "MiniCPMForCausalLM":
        return minicpm_class(model_config.hf_config)
    if arch not in _MODEL_REGISTRY:
        raise ValueError(
            f"architecture {arch!r} is not ported to the PyTorch package "
            f"yet; it serves {sorted(_MODEL_REGISTRY)}. The JAX package "
            "(aphrodite_tpu) serves the others.")
    return _MODEL_REGISTRY[arch]
