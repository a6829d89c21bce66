"""Inference engine — the port of paddle_tpu/inference/__init__.py (ref:
paddle/fluid/inference/api AnalysisConfig / AnalysisPredictor).

Load a saved inference model, run the inference pass pipeline (which
routes the residual LayerNorms, the FFN bias + GELU and the attention onto
the hand-written kernels), and serve it from a private scope on the GPU.
``AnalysisConfig`` defaults to the GPU: ``disable_gpu()`` is the only way
onto the CPU, and without a GPU the predictor raises instead of falling
back."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..framework.core import CPUPlace, CUDAPlace, Program
from ..framework.errors import InvalidArgumentError
from ..framework.executor import Executor, Scope, scope_guard
from ..framework.passes import PassBuilder


class AnalysisConfig:
    """ref: inference/api/paddle_analysis_config.h."""

    def __init__(self, model_dir: Optional[str] = None,
                 params_file: Optional[str] = None):
        self.model_dir = model_dir
        self.prog_file = None
        self.params_file = params_file
        self._ir_optim = True
        self._use_gpu = True
        self._device_id = 0
        self._pass_builder = PassBuilder()

    def set_model(self, model_dir, params_file=None):
        self.model_dir = model_dir
        self.params_file = params_file

    def switch_ir_optim(self, flag: bool = True):
        self._ir_optim = flag

    def ir_optim(self) -> bool:
        return self._ir_optim

    def enable_use_gpu(self, memory_pool_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self) -> bool:
        return self._use_gpu

    def gpu_device_id(self) -> int:
        return self._device_id

    def pass_builder(self) -> PassBuilder:
        return self._pass_builder

    def delete_pass(self, name: str):
        self._pass_builder.delete_pass(name)


class AnalysisPredictor:
    """ref: inference/api/analysis_predictor.cc — load → analyze (passes)
    → run over a private scope.  ``prepare()`` binds the read-only-state
    PreparedStep (weights device-resident) that :class:`ServingEngine`
    drives."""

    def __init__(self, config: AnalysisConfig):
        from .. import io
        self._config = config
        self._scope = Scope()
        place = CUDAPlace(config.gpu_device_id()) if config.use_gpu() \
            else CPUPlace()
        self._exe = Executor(place)
        with scope_guard(self._scope):
            program, feed_names, fetch_vars = io.load_inference_model(
                config.model_dir, self._exe,
                model_filename=config.prog_file,
                params_filename=config.params_file)
        self._fetch_names = [v.name for v in fetch_vars]
        if config.ir_optim():
            program = config.pass_builder().apply(
                program, fetch_names=self._fetch_names, scope=self._scope)
        self._program = program
        self._feed_names = list(feed_names)
        self._fetch_vars = [program.global_block().var(n)
                            for n in self._fetch_names]
        self._prepared = None

    @property
    def device(self):
        return self._exe.device

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def prepare(self, example_feed: Optional[Dict[str, np.ndarray]] = None):
        """Bind the read-only-state prepared fast path (idempotent); an
        ``example_feed`` runs once eagerly."""
        if self._prepared is None:
            self._prepared = self._exe.prepare(
                self._program, feed_names=self._feed_names,
                fetch_list=self._fetch_vars, scope=self._scope,
                feed=example_feed)
        return self._prepared

    @property
    def compiled_executables(self) -> int:
        """Distinct feed-shape signatures the prepared path has served
        (PyTorch compiles nothing; the count keeps the serving stats'
        shape-bucket bound observable)."""
        return self._prepared.signatures if self._prepared is not None \
            else 0

    def _check_feed(self, feed):
        missing = [n for n in self._feed_names if n not in feed]
        extra = [n for n in feed if n not in self._feed_names]
        if missing or extra:
            raise InvalidArgumentError(
                f"predictor feed mismatch: missing {missing}, "
                f"unexpected {extra}; the model declares "
                f"{self._feed_names}")

    def run(self, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        if len(inputs) != len(self._feed_names):
            raise InvalidArgumentError(
                f"AnalysisPredictor.run got {len(inputs)} input(s) but "
                f"the model declares {len(self._feed_names)} feed(s) "
                f"{self._feed_names}")
        return self.run_feed({n: a for n, a in
                              zip(self._feed_names, inputs)})

    def run_feed(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """Dict-keyed run with strict feed-name validation; uses the
        prepared fast path once :meth:`prepare` has been called."""
        self._check_feed(feed)
        if self._prepared is not None:
            return list(self._prepared.run(feed, return_numpy=True))
        return self._exe.run(self._program, feed=dict(feed),
                             fetch_list=self._fetch_vars,
                             scope=self._scope)

    def run_feed_async(self, feed: Dict[str, np.ndarray]) -> List:
        """Dispatch one request without waiting for it: returns lazy
        ``FetchHandle``s (the host blocks only on ``.numpy()``)."""
        self._check_feed(feed)
        if self._prepared is None:
            self.prepare()
        return list(self._prepared.run(feed))

    @property
    def program(self) -> Program:
        return self._program


def create_paddle_predictor(config: AnalysisConfig) -> AnalysisPredictor:
    """ref: inference/api/analysis_predictor.cc CreatePaddlePredictor."""
    return AnalysisPredictor(config)
