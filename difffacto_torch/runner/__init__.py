from .evaluation import evaluate_gen, generate_samples
from .runner import Runner
