"""The frozen reference against the port's CPU path at a tiny size, in the
"highest" precision: streaming inference and the first training steps. The
test imports both; the reference itself imports nothing of the port."""

import torch
from reference import TRAINABLE, TrainerReference, ZeroTIGReference

import frames
import weights
from zero_tig_torch.core.config import Config
from zero_tig_torch.models import build_model
from zero_tig_torch.pipeline.steps import init_carry, init_train_state, predict_chunk, train_step

H, W, OF, IT = 64, 96, 2, 2
OPT = dict(lr=1e-4, weight_decay=3e-4, grad_clip=5.0, adam_beta1=0.9, adam_beta2=0.999)


def test_inference_agrees_with_the_port():
    state = weights.make_state(5, "cpu")
    pool = frames.make_video(6, 4, H, W, "cpu")
    flags = torch.tensor([True, False, False, False])
    model = build_model(state, device="cpu", precision="highest")
    (h2, h3), carry = predict_chunk(model, pool, init_carry(model, (1, H, W, 3)), flags, of_scale=OF,
                                    raft_iters=IT, emit="u8")
    ref = ZeroTIGReference(state)
    c = (torch.zeros(1, 3, H, W), torch.zeros(1, 3, H, W))
    for k in range(4):
        H2, H3, s3 = ref.infer_frame(pool[k].permute(0, 3, 1, 2).float() / 255, c, k == 0, OF, IT)
        c = (H3, s3)
        for got, want in ((h2[k], H2), (h3[k], H3)):
            want = torch.clamp(want * 255, 0, 255).to(torch.uint8).permute(0, 2, 3, 1)
            assert (got.int() - want.int()).abs().max() <= 1  # a truncation at a level's edge
    torch.testing.assert_close(carry["last_H3"], c[0].permute(0, 2, 3, 1), rtol=0, atol=1e-5)
    torch.testing.assert_close(carry["last_s3"], c[1].permute(0, 2, 3, 1), rtol=0, atol=1e-5)


def test_training_agrees_with_the_port():
    state = weights.make_state(7, "cpu", for_training=True)
    pool = frames.make_video(8, 2, H, W, "cpu")
    st = init_train_state(Config(precision="highest", of_scale=OF, raft_iters=IT), state, (1, H, W, 3), device="cpu")
    tr = TrainerReference(state, OPT, (1, 3, H, W))
    for k in range(2):
        st, loss = train_step(st, pool[k], k == 0, of_scale=OF, raft_iters=IT, bn_train=True)
        ref_loss = tr.step(pool[k].permute(0, 3, 1, 2).float() / 255, k == 0, OF, IT, True)
        assert abs(float(loss) - ref_loss) <= 1e-4 * abs(ref_loss)
        if k == 0:
            names = {id(p): n for n, p in st.model.named_parameters()}
            got = {names[id(p)]: float(mu.norm() / 0.1) for p, mu in zip(st.optimizer.params, st.optimizer.mu)}
            want = {n: float(g.norm()) for n, g in tr.first_grads.items()}
            med = sorted(want.values())[len(want) // 2]
            for n in TRAINABLE:
                if want[n] >= 1e-3 * med:
                    assert abs(got[n] - want[n]) <= 1e-3 * max(want[n], med), n
