"""Pricing tables (AWS ap-south-1-ish + OpenAI GPT-4o-mini, as in the paper).

All monetary values in US cents (¢) to match the paper's figures.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Pricing:
    # FaaS (AWS Lambda-like)
    lambda_gb_s_cents: float = 1.6667e-3        # $0.0000166667 per GB-s
    lambda_request_cents: float = 2e-5          # $0.20 per 1M requests
    # Workflow orchestration (Step Functions standard)
    stepfn_transition_cents: float = 2.5e-3     # $25 per 1M state transitions
    # Object store (S3): per-request; storage negligible at our scale
    s3_put_cents: float = 5e-4
    s3_get_cents: float = 4e-5
    # KV store (DynamoDB on-demand)
    kv_write_cents: float = 1.25e-4
    kv_read_cents: float = 2.5e-5
    # LLM (GPT-4o-mini)
    llm_input_per_mtok_cents: float = 15.0      # $0.15 / 1M input tokens
    llm_output_per_mtok_cents: float = 60.0     # $0.60 / 1M output tokens

    def lambda_cost(self, memory_mb: int, duration_s: float) -> float:
        return (memory_mb / 1024.0) * duration_s * self.lambda_gb_s_cents \
            + self.lambda_request_cents

    def llm_cost(self, in_tokens: int, out_tokens: int) -> float:
        return (in_tokens * self.llm_input_per_mtok_cents
                + out_tokens * self.llm_output_per_mtok_cents) / 1e6


PRICING = Pricing()
