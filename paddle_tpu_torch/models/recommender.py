"""MovieLens recommender book model (parity:
python/paddle/fluid/tests/book/test_recommender_system.py — two feature
towers (user: id/gender/age/job embeddings; movie: id embedding +
category sum-pool + title conv-pool), cosine similarity scaled to the
rating range, square_error_cost regression).

All embedding lookups are is_sparse=True: gradients flow as
SelectedRows and apply as scatter-adds (core/selected_rows.py).

The port's counterpart of ``paddle_tpu/models/recommender.py``, line
for line; the dictionary sizes come from the port's own
``dataset.movielens`` copy.
"""
from __future__ import annotations

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import dataset

__all__ = ["get_usr_combined_features", "get_mov_combined_features",
           "get_model"]

IS_SPARSE = True


def get_usr_combined_features():
    usr_dict_size = dataset.movielens.max_user_id() + 1
    uid = fluid.layers.data(name="user_id", shape=[1], dtype="int64")
    usr_emb = fluid.layers.embedding(
        input=uid, size=[usr_dict_size, 32], dtype="float32",
        param_attr="user_table", is_sparse=IS_SPARSE)
    usr_fc = fluid.layers.fc(input=usr_emb, size=32)

    usr_gender_id = fluid.layers.data(name="gender_id", shape=[1],
                                      dtype="int64")
    usr_gender_emb = fluid.layers.embedding(
        input=usr_gender_id, size=[2, 16],
        param_attr="gender_table", is_sparse=IS_SPARSE)
    usr_gender_fc = fluid.layers.fc(input=usr_gender_emb, size=16)

    age_dict_size = len(dataset.movielens.age_table)
    usr_age_id = fluid.layers.data(name="age_id", shape=[1], dtype="int64")
    usr_age_emb = fluid.layers.embedding(
        input=usr_age_id, size=[age_dict_size, 16],
        param_attr="age_table", is_sparse=IS_SPARSE)
    usr_age_fc = fluid.layers.fc(input=usr_age_emb, size=16)

    job_dict_size = dataset.movielens.max_job_id() + 1
    usr_job_id = fluid.layers.data(name="job_id", shape=[1], dtype="int64")
    usr_job_emb = fluid.layers.embedding(
        input=usr_job_id, size=[job_dict_size, 16],
        param_attr="job_table", is_sparse=IS_SPARSE)
    usr_job_fc = fluid.layers.fc(input=usr_job_emb, size=16)

    concat_embed = fluid.layers.concat(
        input=[usr_fc, usr_gender_fc, usr_age_fc, usr_job_fc], axis=1)
    return fluid.layers.fc(input=concat_embed, size=200, act="tanh")


def get_mov_combined_features():
    mov_dict_size = dataset.movielens.max_movie_id() + 1
    mov_id = fluid.layers.data(name="movie_id", shape=[1], dtype="int64")
    mov_emb = fluid.layers.embedding(
        input=mov_id, size=[mov_dict_size, 32], dtype="float32",
        param_attr="movie_table", is_sparse=IS_SPARSE)
    mov_fc = fluid.layers.fc(input=mov_emb, size=32)

    category_size = len(dataset.movielens.movie_categories())
    category_id = fluid.layers.data(name="category_id", shape=[1],
                                    dtype="int64", lod_level=1)
    mov_categories_emb = fluid.layers.embedding(
        input=category_id, size=[category_size, 32], is_sparse=IS_SPARSE)
    mov_categories_hidden = fluid.layers.sequence_pool(
        input=mov_categories_emb, pool_type="sum")

    title_size = len(dataset.movielens.get_movie_title_dict())
    mov_title_id = fluid.layers.data(name="movie_title", shape=[1],
                                     dtype="int64", lod_level=1)
    mov_title_emb = fluid.layers.embedding(
        input=mov_title_id, size=[title_size, 32], is_sparse=IS_SPARSE)
    mov_title_conv = fluid.nets.sequence_conv_pool(
        input=mov_title_emb, num_filters=32, filter_size=3, act="tanh",
        pool_type="sum")

    concat_embed = fluid.layers.concat(
        input=[mov_fc, mov_categories_hidden, mov_title_conv], axis=1)
    return fluid.layers.fc(input=concat_embed, size=200, act="tanh")


def get_model(learning_rate=0.2):
    """(avg_cost, feed vars in reader column order, [scaled predict])."""
    usr = get_usr_combined_features()
    mov = get_mov_combined_features()
    inference = fluid.layers.cos_sim(X=usr, Y=mov)
    scale_infer = fluid.layers.scale(x=inference, scale=5.0)

    label = fluid.layers.data(name="score", shape=[1], dtype="float32")
    square_cost = fluid.layers.square_error_cost(input=scale_infer,
                                                 label=label)
    avg_cost = fluid.layers.mean(square_cost)
    fluid.optimizer.SGD(learning_rate=learning_rate).minimize(avg_cost)

    prog = fluid.default_main_program()
    feed_order = ["user_id", "gender_id", "age_id", "job_id", "movie_id",
                  "category_id", "movie_title", "score"]
    feeds = [prog.global_block().var(n) for n in feed_order]
    return avg_cost, feeds, [scale_infer]
