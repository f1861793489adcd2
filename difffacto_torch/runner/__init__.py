from .evaluation import evaluate_gen, generate_samples
from .runner import Runner
from .extra_runners import GanRunner, LanguageRunner, MixingRunner, PretrainRunner
